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

The attempt objects (``ShardedDeltaAttempt``, its compensated variant,
``ShardedDeltaAttempt2D`` and, for the classic stage path,
``ShardedStageAttempt``) are also on the device protocol of
``merson_solve_device`` (ops/cuda/control.py ``DeviceAttempt``), for a
mesh whose shards share one device (virtual shards of one card, or of the
CPU): the state shards are views of one static buffer; the stage outputs,
the ghost stacks of every stage and, on a 2-D mesh, the y-extended inputs
(their chain-end rows NaN once) are allocated once; every shard's
stage-5 launch writes its own slots of one eps buffer, which the control
kernel reduces (the ``MPI_Allreduce(MAX)``, exact, so the host loop's
bits); the stages are the shard kernels' ``_dev`` entries, which read
their scalars from the control block (the classic stage's Dirichlet top
included: the top shard's kernel decides it on t_s, ``is_top``); the
commit is the commit kernel, one launch per shard.  The overlap split's
side stream is made in the idle attempt before the capture and joined
back within each stage, so a block of attempts is one CUDA graph.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch

from ..core.grid import GridGeometry
from ..models.freezing import physics
from ..models.freezing.delta import two_sum
from ..models.freezing.parameters import FreezingParams
from ..ops.cuda.control import (
    COMMIT_COPY, COMMIT_TWOSUM, ControlBlock, DeviceAttempt,
    commit as commit_dev, merson_control)
from ..ops.cuda.stencil import (
    K_VARS, N_VARS, StencilSpec, commit, delta_g_shard, delta_g_shard_dev,
    delta_ghost_values, eps_slots, fused_stage_shard, fused_stage_shard_dev,
    ghost_planes)
from .sharding import Mesh, split_rows

Shards = List[torch.Tensor]


def halo_bytes_per_attempt(geom: GridGeometry, nz: int = 1, ny: int = 1, *,
                           delta: bool = False, dtype_bytes: int = 4) -> int:
    """Halo copies of one Merson attempt per shard, both directions, in the
    plain layout (shards of n3/nz planes and, for the largest y window,
    ceil(n2/ny) rows).

    z: each stage receives one raw edge plane of w (3 variables) and of
    every K entering its combination (2 each) from each z-neighbour; the
    stages take (0, 1, 2, 3, 3) K's in the classic attempt and
    (0, 1, 2, 2, 3) in the increment form.  On a 2-D mesh the planes carry
    the two ghost rows, and y adds one raw edge row per side of w once per
    attempt and of K1, G2, G3 and G4 once each (the increment form)."""
    stage_k = (0, 1, 2, 2, 3) if delta else (0, 1, 2, 3, 3)
    rows = -(-geom.n2 // ny) + (2 if ny > 1 else 0)
    z = sum(ghost_planes(nk) for nk in stage_k) * 2 * rows * geom.n1
    y = ((N_VARS + 4 * K_VARS) * 2 * (geom.n3 // nz) * geom.n1
         if ny > 1 else 0)
    return (z + y) * dtype_bytes


class _Topology:
    """The shards of a z (and, with ``y_axis``, y) decomposition: their
    devices, positions and windows, the halo copies and their streams.
    z splits into equal parts; y into the windows of ``split_rows``, where
    the first ``n2 % ny`` shards hold one row more."""

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
        if geom.n2 < self.ny:
            raise ValueError(f"n2={geom.n2} has fewer rows than mesh "
                             f"{y_axis}={self.ny}")
        self.zl = geom.n3 // self.nz
        self.rows = [split_rows(geom.n2, self.ny, j) for j in range(self.ny)]
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
        for i, (y, dev) in enumerate(zip(ys, self.devices)):
            want = (nv, self.zl, self.window(i)[1])
            if tuple(y.shape[:3]) != want or y.device != dev:
                raise ValueError(f"expected a shard {want} + (n1,) on {dev}, "
                                 f"got {tuple(y.shape)} on {y.device}")

    def window(self, i: int):
        """(r0, Yl, y0) of shard ``i``'s inputs (see ops/cuda/stencil.py)."""
        ys = self.rows[self.pos[i][1]]
        return (int(self.extended), ys.stop - ys.start, ys.start)

    def is_top(self, i: int) -> bool:
        return self.pos[i][0] == self.nz - 1

    def _nbr(self, i: int, dz: int, dy: int) -> Optional[int]:
        iz, iy = self.pos[i]
        return self._at.get((iz + dz, iy + dy))

    # -- the halo copies --------------------------------------------------

    def extend_y(self, arrs: Shards) -> Shards:
        """Each shard's (nv, zl, Yl, X) array with one raw edge row of each
        y-neighbour around its rows; NaN rows at the chain ends."""
        out = self.ext_alloc(arrs)
        self.extend_into(arrs, out)
        return out

    def ext_alloc(self, arrs: Shards) -> Shards:
        """Buffers for ``extend_into`` of ``arrs``: one row more on each
        side, NaN in the rows at the chain ends."""
        out = []
        for i, a in enumerate(arrs):
            e = torch.empty(a.shape[:2] + (a.shape[2] + 2, a.shape[3]),
                            dtype=a.dtype, device=a.device)
            for row, dy in ((0, -1), (-1, 1)):
                if self._nbr(i, 0, dy) is None:
                    e[:, :, row].fill_(float("nan"))
            out.append(e)
        return out

    def extend_into(self, arrs: Shards, exts: Shards) -> None:
        """Copy each shard's rows and its y-neighbours' raw edge rows into
        its ``ext_alloc`` buffer."""
        for i, (a, e) in enumerate(zip(arrs, exts)):
            e[:, :, 1:-1].copy_(a)
            for row, dy, src_row in ((0, -1, -1), (-1, 1, 0)):
                j = self._nbr(i, 0, dy)
                if j is not None:
                    e[:, :, row].copy_(arrs[j][:, :, src_row])

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


class _ShardedAttempt(DeviceAttempt):
    """What the sharded attempt objects share: the topology and the
    kernels' spec, and on the device protocol (ops/cuda/control.py
    ``DeviceAttempt``) the state shards, the stage outputs, the eps
    buffer, the classic and the delta stage on every shard, and the
    commit.  ``_planes`` is the state's planes in the device loop (5 with
    the compensated commit's lo planes)."""

    _planes = N_VARS
    compensated = False

    def _init(self, geom, params, calc_mode, topo, overlap):
        self.geom = geom
        self._prm = params
        self._topo = topo
        self._spec = StencilSpec.of(geom, params, calc_mode)
        self._split = overlap and topo.zl >= 3
        self.dirichlet = (params.top_temp1, params.top_temp2,
                          params.phase_switch_time)

    # --- the device protocol (control.py DeviceAttempt) ---

    def _dev_state(self, device: torch.device) -> dict:
        """The state shards ``ys``, views of one buffer on ``device``, and
        their w planes ``ws``."""
        topo = self._topo
        if any(d != device for d in topo.devices):
            raise ValueError(
                f"{type(self).__name__}: the device loop serves a mesh whose "
                f"shards share one device, not "
                f"{sorted({str(d) for d in topo.devices})}")
        shapes = [(self._planes, topo.zl, topo.window(i)[1], self.geom.n1)
                  for i in range(topo.size)]
        flat = torch.empty(sum(math.prod(x) for x in shapes),
                           dtype=torch.float32, device=device)
        ys, at = [], 0
        for x in shapes:
            ys.append(flat[at:at + math.prod(x)].view(x))
            at += math.prod(x)
        return {"ys": ys, "ws": [y[:N_VARS] for y in ys]}

    def _k_shards(self, device: torch.device) -> Shards:
        topo = self._topo
        return [torch.empty((K_VARS, topo.zl, topo.window(i)[1],
                             self.geom.n1), dtype=torch.float32,
                            device=device) for i in range(topo.size)]

    def _ghosts(self, ws: Shards, ks) -> list:
        """Every stage's ghost stacks: ``ks[s]`` lists stage s's K inputs
        (each a list of shards), ``ws`` its w shards."""
        n = self._topo.size
        return [self._topo.alloc_ghosts([[ws[i]] + [K[i] for K in kk]
                                         for i in range(n)]) for kk in ks]

    def _eps(self, device: torch.device, kernel: bool, fn_name: str,
             parts) -> tuple:
        """One eps buffer for the stage-5 launches of all shards and each
        shard's list of views of its launches' slots; ``parts[i]`` lists
        the arguments of ``fn_name`` (after the mode) of shard i's
        launches."""
        mode = int(self._spec.mode)
        counts = [[eps_slots(kernel, device, fn_name, mode, *a) for a in pp]
                  for pp in parts]
        eps = torch.empty(sum(map(sum, counts)), dtype=torch.float32,
                          device=device)
        views, at = [], 0
        for cc in counts:
            views.append([])
            for c in cc:
                views[-1].append(eps[at:at + c])
                at += c
        return eps, views

    def _dev_classic(self, ctl: ControlBlock, stage: int, ws: Shards, ks,
                     outs: Shards, ghosts, eps=None) -> None:
        """Classic stage ``stage`` on every shard into ``outs`` (``eps``:
        each shard's slot views, for the tail), with the overlap split
        where the shards allow it."""
        topo, n = self._topo, self._topo.size
        arrs = [[ws[i]] + [K[i] for _, K in ks] for i in range(n)]

        def launch(i, part, g, slot):
            fused_stage_shard_dev(
                self._spec, ctl, stage, ws[i], [(c, K[i]) for c, K in ks], g,
                outs[i], is_top=topo.is_top(i), window=topo.window(i),
                stage5=eps is not None, part=part,
                eps=None if eps is None else eps[i][slot])

        if self._split:
            done = topo.on_side(lambda: topo.fill_ghosts(ghosts, arrs))
            for i in range(n):
                launch(i, "interior", None, 0)
            topo.wait(done)
            for i in range(n):
                launch(i, "edge", ghosts[i], 1)
        else:
            topo.fill_ghosts(ghosts, arrs)
            for i in range(n):
                launch(i, "all", ghosts[i], 0)

    def _dev_delta(self, ctl: ControlBlock, stage: int, ws: Shards, ks,
                   outs: Shards, ghosts, eps=None, emit: str = "y") -> None:
        """Increment-form stage ``stage`` on every shard into ``outs``."""
        topo, n = self._topo, self._topo.size
        topo.fill_ghosts(ghosts, [[ws[i]] + [K[i] for _, K in ks]
                                  for i in range(n)])
        for i in range(n):
            delta_g_shard_dev(
                self._spec, ctl, stage, ws[i], [(c, K[i]) for c, K in ks],
                ghosts[i], outs[i], is_top=topo.is_top(i),
                window=topo.window(i), stage5=eps is not None, emit=emit,
                eps=None if eps is None else eps[i][0])

    def _dev_commit(self, ctl: ControlBlock, b: dict) -> None:
        for y, o in zip(b["ys"], b["out"]):
            if self.compensated:
                commit_dev(ctl, COMMIT_TWOSUM, y[:K_VARS], y[N_VARS:],
                           src=o)
            else:
                commit_dev(ctl, COMMIT_COPY, y[:K_VARS], src=o)

    def _dev_load(self, b: dict, ys: Shards) -> None:
        nv = ys[0].shape[0] if isinstance(ys, list) and ys else 0
        if nv not in (N_VARS, self._planes) or ys[0].dtype != torch.float32:
            raise ValueError(
                f"{type(self).__name__} expects a list of float32 state "
                f"shards of {N_VARS} or {self._planes} planes")
        self._topo.check(ys, nv)
        for dst, y in zip(b["ys"], ys):
            dst[:nv].copy_(y)
            if nv != self._planes:
                dst[nv:].zero_()

    def _dev_unpack(self, b: dict) -> Shards:
        return [y.clone() for y in b["ys"]]


class ShardedDeltaAttempt(_ShardedAttempt):
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
    call and ``commit`` writes into the copies in place; and the device
    protocol of ``merson_solve_device`` (see the module docstring), whose
    commit is the commit kernel's copy (TwoSum, ``compensated``)."""

    def __init__(self, geom: GridGeometry, params: FreezingParams,
                 calc_mode: int, mesh: Mesh, axis_name: str = "z", *,
                 compensated: bool = False, overlap: bool = True):
        self._init(geom, params, calc_mode,
                   _Topology(geom, mesh, z_axis=axis_name), overlap)
        self.compensated = compensated
        self._planes = N_VARS + K_VARS if compensated else N_VARS

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
        topo = self._topo
        ext = topo.extend_y if topo.extended else (lambda a: a)
        D1, dD = delta_ghost_values(t, h, self._prm)
        we = ext(ws)
        K1 = ext(_classic_stage(topo, self._spec, t, h, we, [], False,
                                self._split))
        G2 = ext(self._delta_stage(h, D1, dD[0], we, [(1.0 / 3.0, K1)]))
        G3 = ext(self._delta_stage(h, D1, dD[1], we,
                                   [(1.0 / 3.0, K1), (1.0 / 6.0, G2)]))
        G4 = ext(self._delta_stage(h, D1, dD[2], we,
                                   [(0.5, K1), (0.375, G3)]))
        return self._delta_stage(h, D1, dD[3], we,
                                 [(1.0, K1), (-1.5, G3), (2.0, G4)],
                                 stage5=True, emit=emit)

    # --- merson_solve attempt_fn protocol (as DeltaAttempt) ---

    def pack(self, ys: Shards) -> Shards:
        nv = ys[0].shape[0] if ys else 0
        self._topo.check(ys, nv)
        if nv not in (N_VARS, self._planes) or ys[0].dtype != torch.float32:
            raise ValueError(f"{type(self).__name__} expects float32 state "
                             f"shards of {N_VARS} planes, got {nv} planes "
                             f"of {ys[0].dtype}")
        out = [y.clone(memory_format=torch.contiguous_format) for y in ys]
        if nv != self._planes:
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

    # --- the device protocol ---

    def _dev_alloc(self, device: torch.device, kernel: bool) -> dict:
        topo = self._topo
        b = self._dev_state(device)
        names = ("K1", "G2", "G3", "G4")
        for k in names + ("out",):
            b[k] = self._k_shards(device)
        # the stage inputs: on a 2-D mesh the y-extended copies
        b["in"] = {k: topo.ext_alloc(b[k]) if topo.extended else b[k]
                   for k in ("ws",) + names}
        x = b["in"]
        b["ghosts"] = self._ghosts(x["ws"], (
            [], [x["K1"]], [x["K1"], x["G2"]], [x["K1"], x["G3"]],
            [x["K1"], x["G3"], x["G4"]]))
        tail = 2 if self.compensated else 1
        b["eps"], b["eps_views"] = self._eps(
            device, kernel, "pft_delta_eps_blocks",
            [[(tail, topo.zl, topo.window(i)[1], self.geom.n1)]
             for i in range(topo.size)])
        return b

    def _dev_attempt(self, ctl: ControlBlock, b: dict) -> None:
        topo, x, g = self._topo, b["in"], b["ghosts"]

        def ext(k):
            if topo.extended:
                topo.extend_into(b[k], x[k])
            return x[k]

        we = ext("ws")
        self._dev_classic(ctl, 0, we, [], b["K1"], g[0])
        K1 = ext("K1")
        self._dev_delta(ctl, 1, we, [(1.0 / 3.0, K1)], b["G2"], g[1])
        G2 = ext("G2")
        self._dev_delta(ctl, 2, we, [(1.0 / 3.0, K1), (1.0 / 6.0, G2)],
                        b["G3"], g[2])
        G3 = ext("G3")
        self._dev_delta(ctl, 3, we, [(0.5, K1), (0.375, G3)], b["G4"], g[3])
        G4 = ext("G4")
        self._dev_delta(ctl, 4, we, [(1.0, K1), (-1.5, G3), (2.0, G4)],
                        b["out"], g[4], eps=b["eps_views"],
                        emit="dy" if self.compensated else "y")
        merson_control(ctl)
        self._dev_commit(ctl, b)


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


class ShardedStageAttempt(_ShardedAttempt):
    """The classic stage path over a z mesh (``merson_solve`` with
    ``make_sharded_fused_stage``'s stage_fn, ``increment_form 0``) as an
    attempt object on the device protocol only: the sharded counterpart of
    ops/cuda/stencil.py ``StageAttempt``.  Its five stages are the shard
    stage kernel's ``_dev`` entry (K3's interior and edge passes with the
    overlap split, K1s without) with the coefficients of ``merson_solve``'s
    stage path, and the stage-5 tail's y_spec is copied into (u, p) of each
    state shard by the commit kernel.  The device loop through it equals
    the host loop through the stage_fn bit for bit."""

    def __init__(self, geom: GridGeometry, params: FreezingParams,
                 calc_mode: int, mesh: Mesh, axis_name: str = "z", *,
                 overlap: bool = True):
        self._init(geom, params, calc_mode,
                   _Topology(geom, mesh, z_axis=axis_name), overlap)

    def _dev_alloc(self, device: torch.device, kernel: bool) -> dict:
        topo = self._topo
        b = self._dev_state(device)
        for k in ("K1", "K2", "K3", "K4", "out"):
            b[k] = self._k_shards(device)
        b["ghosts"] = self._ghosts(b["ws"], (
            [], [b["K1"]], [b["K1"], b["K2"]], [b["K1"], b["K3"]],
            [b["K1"], b["K3"], b["K4"]]))
        # the tail's launches: the interior and edge parts, or the whole
        parts = (1, 2) if self._split else (0,)
        b["eps"], b["eps_views"] = self._eps(
            device, kernel, "pft_stage_eps_blocks",
            [[(p, topo.zl, topo.window(i)[1], self.geom.n1) for p in parts]
             for i in range(topo.size)])
        return b

    def _dev_attempt(self, ctl: ControlBlock, b: dict) -> None:
        ws, g = b["ws"], b["ghosts"]
        K1, K2, K3, K4 = b["K1"], b["K2"], b["K3"], b["K4"]
        self._dev_classic(ctl, 0, ws, [], K1, g[0])
        self._dev_classic(ctl, 1, ws, [(1.0 / 3.0, K1)], K2, g[1])
        self._dev_classic(ctl, 2, ws, [(1.0 / 6.0, K1), (1.0 / 6.0, K2)], K3,
                          g[2])
        self._dev_classic(ctl, 3, ws, [(1.0 / 8.0, K1), (3.0 / 8.0, K3)], K4,
                          g[3])
        self._dev_classic(ctl, 4, ws, [(0.5, K1), (-1.5, K3), (2.0, K4)],
                          b["out"], g[4], eps=b["eps_views"])
        merson_control(ctl)
        self._dev_commit(ctl, b)
