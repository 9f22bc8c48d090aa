"""DEM soft-contact forces (PyTorch): the dense pair term.

The counterpart of the ``dense`` strategy of
``porousfreezethaw_tpu/models/dem/forces.py`` (``make_dem_rhs``), itself
the reference's O(n^2) pair scan (``spheres_friction_angular.c:242-357``)
as one masked (n x n) computation: exact, no data structure, and the
correctness oracle for any cell structure.  The JAX package's cell
strategies (``cell_list``, ``cell_roll``, ``cell_lanes``) are shaped for a
TPU's lanes and are not ported; a GPU cell list is still to come.

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
on one device.  The pair tensors are broadcasts of the state, never
materialised copies of it; the largest live temporaries are (n, n, 3).
"""

from __future__ import annotations

from typing import Dict

import torch

from ...core.device import resolve_device
from .config import DEMConfig


def _norm(v: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.norm(v, axis=-1) rounds as vector_norm does
    return torch.linalg.vector_norm(v, dim=-1)


def make_dem_rhs(cfg: DEMConfig, dtype: torch.dtype = torch.float64,
                 neighbor: str = "dense",
                 device: torch.device | str = "cuda"):
    """Build ``rhs(t, y) -> dy/dt`` for the configured variant on
    ``device`` (the GPU unless the caller asks for the CPU; 'cuda' raises
    without one); ``y`` is the state dict of ``dtype`` tensors there.
    ``neighbor`` is 'dense', the exact masked n x n pair term (the JAX
    package's cell strategies are not ported)."""
    if neighbor != "dense":
        raise NotImplementedError(
            f"neighbor strategy {neighbor!r} is not ported yet (the dense "
            "pair term is; a GPU cell list is to come)")
    device = resolve_device(device)
    P_w, n_w = cfg.wall_arrays()
    kin_energy_fraction = cfg.COR * cfg.COR
    two_r = 2.0 * cfg.r
    eps2_3 = 3.0 / (cfg.p_eps1 * cfg.p_eps1)
    eps3_2 = 2.0 / (cfg.p_eps1 * cfg.p_eps1 * cfg.p_eps1)

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

    gravity = torch.tensor(cfg.gravity, dtype=dtype, device=device)
    walls_P = torch.as_tensor(P_w, dtype=dtype, device=device)
    walls_n = torch.as_tensor(n_w, dtype=dtype, device=device)

    def pair_accels(pos, vel, angvel):
        """Summed contact acceleration (and angular acceleration) on each
        particle from every other one: (n, n, 3) pair terms reduced over
        the neighbours (dim 1)."""
        n = pos.shape[0]
        dp = pos[:, None, :] - pos[None, :, :]          # i w.r.t. j
        dist = _norm(dp) + cfg.zero
        mp = dp / dist[..., None]
        del dp
        surf = dist - two_r
        mask = ~torch.eye(n, dtype=torch.bool, device=pos.device)
        mask = mask & (surf <= cfg.max_surf_dist)
        CF = torch.where(mask, collision_factor(surf), 0.0)

        mv = vel[:, None, :] - vel[None, :, :]
        heading = torch.sum(mv * mp, dim=-1)
        acc = torch.sum((CF * rebound(-heading))[..., None] * mp, dim=1)

        angacc = None
        if cfg.has_friction:
            mv_t = mv - heading[..., None] * mp
            del mv
            if angvel is not None:
                # mp points opposite to r (center -> contact point):
                # v_surf contribution is -r * (omega_i + omega_j) x mp
                osum = angvel[:, None, :] + angvel[None, :, :]
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

    def rhs(t, y: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pos, vel = y["pos"], y["vel"]
        angvel = y.get("angvel")

        # ---- particle pairs ----
        pacc, angacc = pair_accels(pos, vel, angvel)
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

    # the JAX drivers check a cell structure's occupancy here; the dense
    # pair term has none
    rhs.neighbor_struct = None
    return rhs
