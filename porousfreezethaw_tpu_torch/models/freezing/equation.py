"""Right-hand side of the freezing/thawing PDE system (plain PyTorch).

The counterpart of ``porousfreezethaw_tpu/models/freezing/equation.py``:
the reference stencil kernels ``f_generic_model01`` / ``f_generic_model2``
(``apps/intertrack-hybrid-S-freezing/equation.c:566-884``) with their
boundary conditions (``equation.c:96-284``), on the inner-cell state
``w`` of shape ``(3, n3, n2, n1)`` = (variables, z, y, x).

Neighbour access clamps the index at the domain edge, which is the FVM
mirror rule (first phantom node == nearest cell, equation.c:187-199); the
temperature's z-top neighbour is the Dirichlet value instead
(equation.c:113-185).  This is the f64 validation path and the oracle of
the CUDA stage kernel.

Models (selected by ``calc_mode``, equation.c:536-555, Params:115-122):

* 0 / 10 — Allen-Cahn phase field with GradP reaction coupling
  (+ heat equation; 10 = temperature frozen in time)
* 1 / 11 — phase field with SigmaP1-P reaction term (S-shape limited)
* 2 — heat equation only, with the algebraic phase field ``p = phf(u)``
  and latent-heat focusing in the denominator (equation.c:850-867)
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ...core.grid import GridGeometry
from . import physics
from .parameters import FreezingParams
from .physics import EPS_REGULARIZATION


class CalcMode(enum.IntEnum):
    GRADP = 0
    SIGMAP = 1
    TEMP = 2
    GRADP_FROZEN_U = 10
    SIGMAP_FROZEN_U = 11


# axis indices inside one field tensor (z, y, x)
_Z, _Y, _X = 0, 1, 2


def _neighbor(f: torch.Tensor, axis: int, direction: int,
              boundary: Optional[float] = None) -> torch.Tensor:
    """Value of the neighbour cell in +-1 ``direction`` along ``axis``.

    Outside the domain the mirror rule gives the cell's own value (the
    index is clamped); a Dirichlet ``boundary`` scalar overrides that at
    the far end (the only Dirichlet face is the top, +z)."""
    n = f.shape[axis]
    if direction < 0:
        return torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                         dim=axis)
    edge = f.narrow(axis, n - 1, 1)
    if boundary is not None:
        edge = torch.full_like(edge, boundary)
    return torch.cat([f.narrow(axis, 1, n - 1), edge], dim=axis)


def dirichlet_at(t: float, prm: FreezingParams, dtype: torch.dtype) -> float:
    """Top temperature at ``t`` decided at the field precision, as the JAX
    package decides it (``t`` is cast to the field dtype first)."""
    if dtype == torch.float32:
        return physics.dirichlet_top_f32(t, prm)
    return physics.dirichlet_top(float(t), prm)


def make_rhs(geom: GridGeometry, params: FreezingParams, calc_mode: int,
             device: torch.device | str,
             noise: Optional[np.ndarray] = None):
    """Build ``rhs(t, w) -> dw/dt`` for ``w`` of shape (3, n3, n2, n1) on
    ``device``.  ``t`` is a host scalar.

    ``noise`` is the precomputed per-cell temperature noise field
    (PRECALC_DATA.u_noise, equation.c:449-456), a numpy array moved to
    ``device`` here; None means no noise (the shipped Params uses
    u_noise_amp = 0)."""
    mode = CalcMode(calc_mode)
    p_ = params
    device = torch.device(device)
    coeffs = physics.Coeffs.of(p_)
    noise_t = (None if noise is None
               else torch.as_tensor(np.asarray(noise), device=device))

    inv_h1, inv_h2, inv_h3 = geom.inv_h
    h1_2, h2_2, h3_2 = inv_h1**2, inv_h2**2, inv_h3**2
    h1d2, h2d2, h3d2 = 0.5 * inv_h1, 0.5 * inv_h2, 0.5 * inv_h3

    rho = lambda p, gl: physics.rho(p, gl, p_)
    cp = lambda p, gl: physics.cp(p, gl, p_)
    lam = lambda p, gl: physics.lam(p, gl, p_)
    water_indicator = lambda gl: physics.water_indicator(gl, p_)
    f_gradp = lambda u, p, gn: physics.f_gradp(u, p, gn, p_, coeffs)
    f_sigmap1_p = lambda u, p: physics.f_sigmap1_p(u, p, p_, coeffs)
    dphf_du = lambda u: physics.dphf_du(u, p_)

    def laplacian(f):
        """div(grad f) on the FVM grid with mirror BCs (zero flux)."""
        out = h1_2 * (_neighbor(f, _X, -1) + _neighbor(f, _X, +1) - 2.0 * f)
        out += h2_2 * (_neighbor(f, _Y, -1) + _neighbor(f, _Y, +1) - 2.0 * f)
        out += h3_2 * (_neighbor(f, _Z, -1) + _neighbor(f, _Z, +1) - 2.0 * f)
        return out

    def div_lambda_grad_u(u, p, gl, top):
        """div(lambda grad u); face conductivity = lambda(arithmetic mean of
        p, gl at the face) (equation.c:711-723); Dirichlet top BC on u."""
        def flux(axis, direction, u_b=None):
            un = _neighbor(u, axis, direction, u_b)
            pn = _neighbor(p, axis, direction)
            gln = _neighbor(gl, axis, direction)
            return lam(0.5 * (p + pn), 0.5 * (gl + gln)) * (un - u)

        out = h1_2 * (flux(_X, -1) + flux(_X, +1))
        out += h2_2 * (flux(_Y, -1) + flux(_Y, +1))
        out += h3_2 * (flux(_Z, -1) + flux(_Z, +1, top))
        return out

    def rhs(t, w: torch.Tensor) -> torch.Tensor:
        if w.device != device:
            raise ValueError(f"rhs built for {device}, got a state on "
                             f"{w.device}")
        u, p, gl = w[0], w[1], w[2]
        top = dirichlet_at(float(t), p_, w.dtype)
        u_noisy = u if noise_t is None else u + noise_t.to(w.dtype)

        if mode == CalcMode.TEMP:
            # --- model 2 (equation.c:745-884) ---
            dp_du = dphf_du(u) * water_indicator(gl)
            denom = rho(p, gl) * (cp(p, gl) - p_.L * dp_du)
            du_dt = div_lambda_grad_u(u, p, gl, top) / denom
            dp_dt = dp_du * du_dt
        else:
            # --- models 0/1 (+frozen-u 10/11) (equation.c:566-741) ---
            dp_dt = laplacian(p)
            if mode in (CalcMode.GRADP, CalcMode.GRADP_FROZEN_U):
                gradp_norm = torch.sqrt(
                    (h1d2 * (_neighbor(p, _X, +1) - _neighbor(p, _X, -1))) ** 2
                    + (h2d2 * (_neighbor(p, _Y, +1) - _neighbor(p, _Y, -1))) ** 2
                    + (h3d2 * (_neighbor(p, _Z, +1) - _neighbor(p, _Z, -1))) ** 2
                ) + EPS_REGULARIZATION
                dp_dt += f_gradp(u_noisy, p, gradp_norm)
            else:
                dp_dt += f_sigmap1_p(u_noisy, p)
            dp_dt = dp_dt / p_.alpha * water_indicator(gl)

            if mode in (CalcMode.GRADP_FROZEN_U, CalcMode.SIGMAP_FROZEN_U):
                du_dt = torch.zeros_like(u)
            else:
                du_dt = (div_lambda_grad_u(u, p, gl, top) / rho(p, gl)
                         + p_.L * dp_dt) / cp(p, gl)

        dgl_dt = torch.zeros_like(gl)  # glass balls are static (equation.c:727-731)
        return torch.stack([du_dt, dp_dt, dgl_dt])

    return rhs


def make_noise_field(geom: GridGeometry, params: FreezingParams, seed: int,
                     dtype=np.float64) -> Optional[np.ndarray]:
    """Per-cell temperature noise  u_noise_amp * (U(0,1) - 0.5)
    (equation.c:449-456), drawn from numpy's PCG64 seeded with ``seed``.
    The reference uses per-rank libc rand() and the JAX package the
    threefry PRNG, so the three draw different noise; the shipped Params
    set u_noise_amp = 0, where all agree exactly."""
    if params.u_noise_amp == 0.0:
        return None
    uni = np.random.default_rng(seed).random(geom.shape, dtype=np.float64)
    return (params.u_noise_amp * (uni - 0.5)).astype(dtype)
