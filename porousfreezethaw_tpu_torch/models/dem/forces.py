"""DEM soft-contact forces (PyTorch): the dense pair term, the cell list
and the particle-sharded dense term.

The counterpart of ``porousfreezethaw_tpu/models/dem/forces.py``
(``make_dem_rhs``), itself the reference's O(n^2) pair scan
(``spheres_friction_angular.c:242-357``).  Every strategy gathers, for each
particle, a set of candidate neighbours and hands them to one pair-force
function (``pair_accels``), reduced over the candidates:

* ``dense`` -- every other particle, as one masked (n x n) computation:
  exact, no data structure, and the correctness oracle of the others.
* ``cell_list`` / ``cell_lanes`` -- the particles of the 27 cells around
  a particle's own, on a grid of cell edge 2r + max_surf_dist (the
  interaction range), from a sorted-cell table of ``capacity`` slots a
  cell (:func:`make_cell_list`): O(n * 27 * capacity) work.  The JAX
  package's ``cell_lanes`` lays the cells out as (3, K, C) with rolls
  along the lanes, a form made for a TPU's (8, 128) register tiling; on
  a GPU the gather of the candidates is the natural form, and both names
  run it.  ``cell_lanes`` guards its capacity: when a cell holds more
  than K particles, the pair accelerations are NaN (the JAX package's
  contract), where ``cell_list`` drops the excess silently.
  ``cell_roll``, the superseded TPU roll layout, finds ``cell_list``'s
  pairs and is not ported.
* ``mesh=`` -- the dense term with the particles sharded over a mesh axis:
  each shard computes its own rows against the whole state gathered onto
  its device, the counterpart of the JAX package's ``shard_map`` body.
  A row's neighbour sum is the single-device one, so the result is the
  single-device result bit for bit.

Force model (constants in :class:`.config.DEMConfig`), as in the JAX
package, operation for operation:

* collision factor  CF = cfm * exp(-cfe * surf_dist)  (exp model,
  spheres_basic.c:202-207) or the Walton–Braun spring
  ``CF = -k * surf_dist`` for overlap only (spheres_basic_WB.c:207-209)
* velocity-dependent rebound factor  COR^2..1 via tanh
  (spheres_basic.c:192-200)
* tangential friction  FF = CF * mu_f * S(|v_t|)  with the S-shape
  low-velocity limiter (spheres_friction.c:230-240)
* rotation: surface velocity omega x r added to the tangential velocity,
  torque tau = r*FF/I applied to angular acceleration
  (spheres_friction_angular.c:298-321, 339-354)

State: a dict {'pos': (n,3), 'vel': (n,3)[, 'angvel': (n,3)]} of tensors
on one device; on a mesh, the list of the shards' dicts in mesh order
(``parallel.sharding.shard_dem_state``).  The dense pair tensors are
broadcasts of the state; the largest live temporaries are (rows, n, 3),
or (n, 27 * capacity, 3) for the cell list.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from ...core.device import resolve_device
from ...solvers.merson import MAX_STEPS, merson_solve, merson_solve_device
from .attempt import DEMAttempt
from .config import DEMConfig

# attempts per solver call with a cell structure (the JAX app's chunk on an
# accelerator); the fullest cell is checked between calls
CELL_CHUNK = 512

# 27 neighbour-cell offsets (own cell included), in the JAX package's order
_OFFSETS = [(dx, dy, dz)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _norm(v: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.norm(v, axis=-1) rounds as vector_norm does
    return torch.linalg.vector_norm(v, dim=-1)


def default_cell_bounds(cfg: DEMConfig):
    """Bounding box ``(lo, hi)`` of the cell grid: the vessel plus headroom
    for the elevated initial block and slack for wall penetration.

    The height model is ``icond_dense``'s (the tallest initializer):
    ``floor(R / 2.5r)^2`` spheres per layer at spacing ``R / bpr``
    (spheres_friction_angular.c:454-489).  An ``n^(1/3)``-layer model
    underestimates large beds: the JAX package found particles above the
    box clipped into the top cell layer, past its capacity, at n = 20 000."""
    bpr = max(1, math.floor(cfg.R / (2.5 * cfg.r)))
    distance = cfg.R / bpr
    n_layers = math.ceil(cfg.n / (bpr * bpr))
    z_top = cfg.h0 + (n_layers + 2) * distance
    pad = 4.0 * cfg.r
    return (-pad, -pad, -pad), (cfg.R + pad, cfg.R + pad, z_top + pad)


def make_cell_list(cfg: DEMConfig, capacity: int = 16, bounds=None,
                   dtype: torch.dtype = torch.float64,
                   device: torch.device | str = "cuda"):
    """Build ``neighbor_ids(pos) -> (ids, mask, overflow)``: ``ids`` the
    (n, 27 * capacity) candidate indices (0 where there is none), ``mask``
    the real candidates (not the particle itself), ``overflow`` a 0-d bool
    tensor on the device, true when a cell holds more than ``capacity``
    particles (whose excess is then left out).

    The cells are those of the box ``bounds`` (:func:`default_cell_bounds`
    by default) at edge 2r + max_surf_dist; a particle outside is binned
    into the nearest cell.  The table is the particles stably sorted by
    cell: slot ``cell * capacity + k`` holds the cell's k-th particle in
    index order, as the JAX package's stable ``argsort`` orders them.
    ``neighbor_ids.cell_occupancy(pos)`` is the fullest cell's count (one
    device sync)."""
    device = resolve_device(device)
    lo, hi = bounds if bounds is not None else default_cell_bounds(cfg)
    edge = 2.0 * cfg.r + cfg.max_surf_dist
    dims = tuple(int(math.ceil((hi[d] - lo[d]) / edge)) for d in range(3))
    nx, ny, nz = dims
    ncells = nx * ny * nz
    K = capacity
    lo_t = torch.tensor(lo, dtype=dtype, device=device)
    top = torch.tensor(dims, dtype=torch.int64, device=device) - 1
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=device)
    kk = torch.arange(K, device=device)

    def cell_coords(pos):
        ci = torch.floor((pos - lo_t) / edge).to(torch.int64)
        return torch.minimum(ci.clamp_min(0), top)

    def flat(ci):
        return (ci[..., 2] * ny + ci[..., 1]) * nx + ci[..., 0]

    def neighbor_ids(pos):
        n = pos.shape[0]
        idx = torch.arange(n, device=device)
        ci = cell_coords(pos)
        scid, order = torch.sort(flat(ci), stable=True)
        rank = idx - torch.searchsorted(scid, scid, side="left")
        overflow = rank.max() >= K
        # ranks past the capacity go to one spare slot that nothing reads
        slot = torch.where(rank < K, scid * K + rank, ncells * K)
        table = torch.full((ncells * K + 1,), -1, dtype=torch.int64,
                           device=device)
        table.scatter_(0, slot, order)
        cand = ci[:, None, :] + offs                         # (n, 27, 3)
        in_range = ((cand >= 0) & (cand <= top)).all(dim=-1)  # (n, 27)
        cand_cid = torch.where(in_range, flat(cand), 0)
        ids = table[(cand_cid[..., None] * K + kk).reshape(n, -1)]
        # in_range of each candidate's cell, by an expand: its size comes
        # from the shapes, so a CUDA graph's capture meets no sync
        mask = ((ids >= 0) & (ids != idx[:, None])
                & in_range[:, :, None].expand(n, 27, K).reshape(n, -1))
        return ids.clamp_min(0), mask, overflow

    def cell_occupancy(pos) -> int:
        """Particles in the fullest cell; must stay <= capacity."""
        ci = cell_coords(torch.as_tensor(pos, dtype=dtype, device=device))
        return int(torch.bincount(flat(ci), minlength=ncells).max())

    neighbor_ids.dims = dims
    neighbor_ids.capacity = K
    neighbor_ids.cell_occupancy = cell_occupancy
    return neighbor_ids


class CellOverflowError(RuntimeError):
    """A cell holds more particles than the cell structure's capacity."""


def solve_guarded(rhs, state, final_time: float, params,
                  attempts: int | None = None, chunk: int = CELL_CHUNK):
    """``merson_solve`` toward ``final_time`` (or for ``attempts`` attempts
    when given), checking the fullest cell of ``rhs.neighbor_struct``
    after every ``chunk`` attempts: densification past the capacity would
    drop pairs, and the check names the cause before the NaN backoff
    grinds h into the floor.  Without a cell structure it is one solve.
    Given a :class:`DEMAttempt` in place of ``rhs``, each solve call is
    ``merson_solve_device`` (the device-resident loop), with the same
    chunks and checks.

    Returns ``(state, status, max_occupancy)`` (None without cells);
    raises :class:`CellOverflowError` with the JAX app's message."""
    cells = rhs.neighbor_struct
    start = state.steps_total
    occupancy = None
    while True:
        left = (params.max_steps if attempts is None
                else attempts - (state.steps_total - start))
        step = left if cells is None else min(chunk, left)
        prm = dataclasses.replace(params, max_steps=step)
        if isinstance(rhs, DEMAttempt):
            state, status = merson_solve_device(state, final_time, prm, rhs)
        else:
            state, status = merson_solve(rhs, state, final_time, prm)
        if cells is not None:
            occ = cells.cell_occupancy(state.y["pos"])
            occupancy = occ if occupancy is None else max(occupancy, occ)
            if occ > cells.capacity:
                raise CellOverflowError(
                    f"cell occupancy {occ} exceeds capacity "
                    f"{cells.capacity} at t={state.t:.4f}: rerun with a "
                    f"larger --cell-capacity or --neighbor dense")
        if (cells is None or status != MAX_STEPS or attempts is not None
                and state.steps_total - start >= attempts):
            return state, status, occupancy


def make_dem_rhs(cfg: DEMConfig, dtype: torch.dtype = torch.float64,
                 neighbor: str = "dense", cell_capacity: int = 16,
                 cell_bounds=None, mesh=None, axis_name: str = "p",
                 device: torch.device | str = "cuda"):
    """Build ``rhs(t, y) -> dy/dt`` for the configured variant.

    ``neighbor``: 'dense', 'cell_list' or 'cell_lanes' (see the module
    docstring; ``cell_capacity`` and ``cell_bounds`` configure the cells).
    ``y`` is the state dict of ``dtype`` tensors on ``device`` (the GPU
    unless the caller asks for the CPU; 'cuda' raises without one).

    ``mesh``: a :class:`..parallel.sharding.Mesh` whose one axis
    ``axis_name`` shards the particles (dense only, as in the JAX
    package); ``y`` is then the list of the shards' dicts, each on its
    mesh device, and so is the result.

    ``rhs.neighbor_struct`` is the cell structure (its ``capacity`` and
    ``cell_occupancy``), or None for the dense term."""
    P_w, n_w = cfg.wall_arrays()
    kin_energy_fraction = cfg.COR * cfg.COR
    two_r = 2.0 * cfg.r
    eps2_3 = 3.0 / (cfg.p_eps1 * cfg.p_eps1)
    eps3_2 = 2.0 / (cfg.p_eps1 * cfg.p_eps1 * cfg.p_eps1)

    if neighbor == "cell_roll":
        raise ValueError(
            "neighbor 'cell_roll' is not ported: it finds the pairs of "
            "'cell_list' in a TPU roll layout; use 'cell_lanes'")
    if neighbor not in ("dense", "cell_list", "cell_lanes"):
        raise ValueError(f"unknown neighbor strategy {neighbor!r}")
    rows = None
    if mesh is not None:
        if neighbor != "dense":
            raise ValueError("mesh sharding supports the dense neighbor "
                             "strategy (the cell list is single-device)")
        from ...parallel.sharding import dem_sharding
        rows = dem_sharding(mesh, cfg.n, axis_name)
    else:
        device = resolve_device(device)
    nbr = None
    if neighbor != "dense":
        nbr = make_cell_list(cfg, capacity=cell_capacity, bounds=cell_bounds,
                             dtype=dtype, device=device)

    def rebound(v):
        # smooth restitution: ~1 for v>0, ~COR^2 for v<0 (spheres_basic.c:192)
        return kin_energy_fraction + 0.5 * (1.0 - kin_energy_fraction) * (
            1.0 + torch.tanh(v * cfg.dissipation_focusing))

    if cfg.variant == "basic_WB":
        def collision_factor(surf):
            return torch.where(surf > 0, 0.0, -cfg.WB_stiffness * surf)
    else:
        def collision_factor(surf):
            return cfg.collision_force_multiplier * torch.exp(
                -cfg.collision_force_exponent * surf)

    def friction_factor(x):
        lim = x * x * (eps2_3 - eps3_2 * x)
        return torch.where(x >= cfg.p_eps1, 1.0, lim)

    consts: Dict[torch.device, tuple] = {}

    def constants(dev):
        """gravity, wall points, wall normals and the NaN of the guarded
        capacity on ``dev``, copied once: a copy from the host inside a
        CUDA graph's capture fails."""
        if dev not in consts:
            consts[dev] = (torch.tensor(cfg.gravity, dtype=dtype, device=dev),
                           torch.as_tensor(P_w, dtype=dtype, device=dev),
                           torch.as_tensor(n_w, dtype=dtype, device=dev),
                           torch.tensor(math.nan, dtype=dtype, device=dev))
        return consts[dev]

    def pair_accels(pos, vel, angvel, npos, nvel, nang, mask):
        """Summed contact acceleration (and angular acceleration) on each
        row particle from its candidates: ``npos`` etc. are (1, m, 3)
        broadcasts or (rows, m, 3) gathers, ``mask`` (rows, m) the real
        ones; the pair terms are reduced over the candidates (dim 1)."""
        dp = pos[:, None, :] - npos                     # i w.r.t. j
        dist = _norm(dp) + cfg.zero
        mp = dp / dist[..., None]
        del dp
        surf = dist - two_r
        mask = mask & (surf <= cfg.max_surf_dist)
        CF = torch.where(mask, collision_factor(surf), 0.0)

        mv = vel[:, None, :] - nvel
        heading = torch.sum(mv * mp, dim=-1)
        acc = torch.sum((CF * rebound(-heading))[..., None] * mp, dim=1)

        angacc = None
        if cfg.has_friction:
            mv_t = mv - heading[..., None] * mp
            del mv
            if angvel is not None:
                # mp points opposite to r (center -> contact point):
                # v_surf contribution is -r * (omega_i + omega_j) x mp
                osum = angvel[:, None, :] + nang
                sv = torch.linalg.cross(osum, mp)
                del osum
                mv_t = mv_t - cfg.r * sv
                del sv
            mvt_mag = _norm(mv_t) + cfg.zero
            tdir = mv_t / mvt_mag[..., None]
            del mv_t
            FF = CF * cfg.friction * friction_factor(mvt_mag)
            acc = acc - torch.sum(FF[..., None] * tdir, dim=1)
            if angvel is not None:
                torque = torch.linalg.cross(mp, tdir)
                angacc = torch.sum(
                    (cfg.r * FF / cfg.inertia)[..., None] * torque, dim=1)
        return acc, angacc

    def dense_accels(pos, vel, angvel, full, row0):
        """The rows ``row0 ..`` of the dense pair term: ``pos`` etc. are
        those rows, ``full`` the whole state on their device."""
        n, N = pos.shape[0], full["pos"].shape[0]
        own = torch.arange(row0, row0 + n, device=pos.device)
        mask = own[:, None] != torch.arange(N, device=pos.device)[None, :]
        ang = full.get("angvel")
        return pair_accels(pos, vel, angvel, full["pos"][None],
                           full["vel"][None],
                           ang[None] if ang is not None else None, mask)

    def cell_accels(pos, vel, angvel):
        ids, mask, overflow = nbr(pos)
        acc, angacc = pair_accels(
            pos, vel, angvel, pos[ids], vel[ids],
            angvel[ids] if angvel is not None else None, mask)
        if neighbor == "cell_lanes":
            # guarded capacity: a cell past K particles would drop pairs
            # silently; poison the result so that the failure is loud
            # (the solver's NaN handling rejects the step; the app and
            # the bench check cell_occupancy at chunk boundaries and name
            # the cause)
            nan = constants(acc.device)[3]
            acc = torch.where(overflow, nan, acc)
            if angacc is not None:
                angacc = torch.where(overflow, nan, angacc)
        return acc, angacc

    def forces(y: Dict[str, torch.Tensor], full=None, row0=0
               ) -> Dict[str, torch.Tensor]:
        """dy/dt of the rows in ``y``: pairs, gravity and walls."""
        pos, vel = y["pos"], y["vel"]
        angvel = y.get("angvel")
        gravity, walls_P, walls_n, _ = constants(pos.device)

        # ---- particle pairs ----
        if nbr is not None:
            pacc, angacc = cell_accels(pos, vel, angvel)
        else:
            pacc, angacc = dense_accels(pos, vel, angvel,
                                        y if full is None else full, row0)
        acc = gravity + pacc

        # ---- walls ----
        rel = pos[:, None, :] - walls_P[None, :, :]     # (n, walls, 3)
        wsurf = -torch.sum(rel * walls_n[None, :, :], dim=-1) - cfg.r
        wmask = wsurf <= cfg.max_surf_dist
        WCF = torch.where(wmask, collision_factor(wsurf), 0.0)
        wheading = torch.sum(vel[:, None, :] * walls_n[None, :, :], dim=-1)
        acc = acc - torch.sum(
            (WCF * rebound(wheading))[..., None] * walls_n[None, :, :],
            dim=1)

        if cfg.has_friction:
            wv_t = vel[:, None, :] - wheading[..., None] * walls_n[None, :, :]
            if angvel is not None:
                # wall normal points the SAME way as r here: +r * omega x n
                wsv = torch.linalg.cross(angvel[:, None, :],
                                         walls_n[None, :, :])
                wv_t = wv_t + cfg.r * wsv
            wvt_mag = _norm(wv_t) + cfg.zero
            wtdir = wv_t / wvt_mag[..., None]
            WFF = WCF * cfg.friction * friction_factor(wvt_mag)
            acc = acc - torch.sum(WFF[..., None] * wtdir, dim=1)
            if angvel is not None:
                wtorque = torch.linalg.cross(walls_n[None, :, :], wtdir)
                angacc = angacc - torch.sum(
                    (cfg.r * WFF / cfg.inertia)[..., None] * wtorque, dim=1)

        out = {"pos": vel, "vel": acc}
        if angvel is not None:
            out["angvel"] = (angacc if angacc is not None
                             else torch.zeros_like(angvel))
        return out

    if mesh is None:
        def rhs(t, y: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            return forces(y)
        # the app and the bench check a cell structure's occupancy at
        # chunk boundaries; None for the dense term, which has no capacity
        rhs.neighbor_struct = nbr
        rhs.cfg, rhs.dtype, rhs.mesh = cfg, dtype, None
        return rhs

    def rhs_sharded(t, ys: List[Dict[str, torch.Tensor]]
                    ) -> List[Dict[str, torch.Tensor]]:
        if len(ys) != len(rows):
            raise ValueError(f"{len(ys)} shards for a mesh of {len(rows)}")
        # the whole state, gathered once onto each device of the mesh
        fulls: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        out = []
        for y, sl in zip(ys, rows):
            dev = y["pos"].device
            if dev not in fulls:
                fulls[dev] = {k: torch.cat([s[k].to(dev) for s in ys])
                              for k in y}
            out.append(forces(y, fulls[dev], sl.start))
        return out

    rhs_sharded.neighbor_struct = None      # the mesh path is dense-only
    rhs_sharded.cfg, rhs_sharded.dtype, rhs_sharded.mesh = cfg, dtype, mesh
    return rhs_sharded
