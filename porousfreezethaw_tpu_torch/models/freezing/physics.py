"""Cell-local physics of the freezing model, shared by the f64 stencil
(equation.py), the increment form (delta.py) and the plain versions of the
CUDA kernels (ops/cuda/stencil.py).

All functions are elementwise torch math over tensors of any shape;
formulas follow equation.c:341-421 and the precalculated auxiliaries
equation.c:439-447.  Scalar parameters are Python floats (f64 on the host);
torch rounds them to the tensor's dtype where they meet a tensor, so an
f32 field sees each constant rounded once, as the kernels receive it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .parameters import FreezingParams

EPS_REGULARIZATION = 1e-10  # equation.c:330


@dataclasses.dataclass(frozen=True)
class Coeffs:
    """Precomputed scalar coefficients (PrecalculateData, equation.c:439-447)."""

    xi_2_inv_a: float
    xi_inv_b_sqrt_a2: float
    eps2_3: float
    eps3_2: float

    @staticmethod
    def of(p: FreezingParams) -> "Coeffs":
        d = p.p_eps1 - p.p_eps0
        return Coeffs(
            xi_2_inv_a=p.a / (p.xi * p.xi),
            xi_inv_b_sqrt_a2=p.b * (0.5 * p.a) ** 0.5 / p.xi,
            eps2_3=3.0 / (d * d),
            eps3_2=2.0 / (d * d * d),
        )


def rho(p_, gl, prm: FreezingParams):
    return gl * prm.glass_rho + (1.0 - gl) * (
        p_ * prm.ice_rho + (1.0 - p_) * prm.water_rho)


def cp(p_, gl, prm: FreezingParams):
    return gl * prm.glass_cp + (1.0 - gl) * (
        p_ * prm.ice_cp + (1.0 - p_) * prm.water_cp)


def lam(p_, gl, prm: FreezingParams):
    return gl * prm.glass_lambda + (1.0 - gl) * (
        p_ * prm.ice_lambda + (1.0 - p_) * prm.water_lambda)


def water_indicator(gl, prm: FreezingParams):
    # torch.clamp_min propagates NaN, as jnp.maximum does
    return torch.clamp_min(1.0 - prm.zeta * gl, 0.0)


def sshape(x, prm: FreezingParams, c: Coeffs):
    xs = x - prm.p_eps0
    mid = xs * xs * (c.eps2_3 - c.eps3_2 * xs)
    return torch.where(x <= prm.p_eps0, torch.zeros_like(mid),
                       torch.where(x >= prm.p_eps1, torch.ones_like(mid), mid))


def f_gradp(u, p_, gradp_norm, prm: FreezingParams, c: Coeffs):
    return (c.xi_2_inv_a * p_ * (1.0 - p_) * (p_ - 0.5)
            - prm.b * prm.alpha * prm.mu * gradp_norm * (u - prm.u_star))


def f_sigmap1_p(u, p_, prm: FreezingParams, c: Coeffs):
    pq = p_ * (1.0 - p_)
    return (c.xi_2_inv_a * p_ * (1.0 - p_) * (p_ - 0.5)
            - c.xi_inv_b_sqrt_a2 * prm.alpha * prm.mu
            * sshape(p_, prm, c) * sshape(1.0 - p_, prm, c)
            * torch.clamp_min(pq, 0.0) * (u - prm.u_star))


def dphf_du(u, prm: FreezingParams):
    # -gamma/2 * sech^2(gamma (u - u*)), with sech written in exps as
    # 2 e^{-|x|} / (1 + e^{-2|x|}): overflow-free at any |x|, and the same
    # rounding as the JAX package's formula (not torch.cosh)
    x = torch.abs(prm.gamma * (u - prm.u_star))
    e = torch.exp(-x)
    sech = 2.0 * e / (1.0 + e * e)
    return -0.5 * prm.gamma * (sech * sech)


def dirichlet_top(t: float, prm: FreezingParams) -> float:
    """Top temperature at time ``t`` (a host scalar).  The comparison is
    made at ``t``'s own precision: callers that model an f32 kernel pass
    ``t`` and the switch time rounded to f32 (see ``dirichlet_top_f32``)."""
    return prm.top_temp1 if t < prm.phase_switch_time else prm.top_temp2


def dirichlet_top_f32(t: float, prm: FreezingParams) -> float:
    """``dirichlet_top`` decided as an f32 kernel decides it: ``t`` and the
    switch time rounded to f32 before the comparison, the value rounded to
    f32 (the JAX fused stage receives t_stage as f32)."""
    t32 = np.float32(t)
    v = (prm.top_temp1 if t32 < np.float32(prm.phase_switch_time)
         else prm.top_temp2)
    return float(np.float32(v))
