"""Increment-form (delta) right-hand side for the freezing models.

``compute_rhs_delta`` evaluates

    G = f(w + d) - f(w)

*exactly* (as an algebraic identity, not a linearization), expanded so
that no term subtracts two large nearly-equal quantities: every product
of the expansion carries at least one factor of the small increment
``d``.  Evaluated in f32 this removes the error-estimator noise floor
that pins the Merson controller on stiff f32 runs:

* the classic stage evaluation rounds each stage state
  ``y_i = fl(w + h*sum c K)`` to f32, committing an h-INDEPENDENT error
  ~ulp(w)/2 per field that the RHS Jacobian amplifies into the
  estimator (measured floors on the developed MR GradP bed: u 2.5e-4,
  p 4.2e-4 vs the controller's growth fixed point 0.328*delta =
  3.28e-4 — see PERFORMANCE.md, scripts/repros/_r3_noise_floor_attribution.py);
* in increment form the stages carry ``K1 = f(w)`` plus small
  ``G_i = f(w + d_i) - f(w)``; since the Merson error combination
  ``0.2 K1 - 0.9 K3 + 0.8 K4 - 0.1 K5`` has K1-coefficient sum
  0.2 - 0.9 + 0.8 - 0.1 = 0, it reduces to ``-0.9 G3 + 0.8 G4 - 0.1 G5``
  — the large common value never enters the estimate at all, and the
  G's own rounding is *relative* (vanishes ~h with the step), restoring
  the reference f64 step-size behavior in f32.

Stage algebra used by the solver (K_i = K1 + G_i, G_1 = 0):

    d_2 = h * (1/3) K1
    d_3 = h * ((1/3) K1 + (1/6) G2)
    d_4 = h * ((1/2) K1 + (3/8) G3)
    d_5 = h * (      K1 - (3/2) G3 + 2 G4)
    eps    = max |-0.9 G3 + 0.8 G4 - 0.1 G5|
    update = w + h K1 + (h/3)(2 G4 + 0.5 G5)

Expansion rules (each exact; w-only subterms are recomputed per stage as
common subexpressions — their rounding is shared, never differenced):

* material blends are LINEAR in p (equation.c:341-357), so
  ``blend(p+b) = blend(p) + b * slope(gl)`` exactly;
* face flux: ``lam' (u'_n - u') - lam (u_n - u) =
  lam*(a_n - a) + bbar*lam_p*((u_n - u) + (a_n - a))``;
* rational terms via ``X/Y - x/y = (dx*y - x*dy) / (Y*y)``;
* polynomial reaction terms via exact finite-difference expansions
  (``g(p+b) - g(p) = b*(g'(p) + b*(1.5 - 3p) - b^2)`` for the
  double-well ``g(p) = p(1-p)(p-1/2)``);
* ``|grad p|`` via ``sqrt(S') - sqrt(S) = dS / (sqrt(S') + sqrt(S))``;
* products via telescoping ``PROD X_i - PROD x_i = sum_k X_1..X_{k-1}
  dx_k x_{k+1}..x_n``;
* tanh/sech^2 (Temp model) via the addition theorem
  ``tanh(x+d) - tanh(x) = tanh(d)(1 - tanh^2 x)/(1 + tanh(x)tanh(d))``.

The S-shape limiter (piecewise cubic with clamps, equation.c:375-388)
uses the exact cubic expansion when both arguments fall in the open mid
branch and a direct difference otherwise (there one side is the exact
constant 0 or 1, so the subtraction is benign).

The Dirichlet top boundary enters through the ghost values supplied by
the caller: old u-ghost = D(t_stage1), delta a-ghost =
D(t_stage_i) - D(t_stage1) (zero except for the single step that
crosses phase_switch_time, where it is exact).

Noise fields are not supported on this path (the shipped Params uses
u_noise_amp = 0); a static noise field would cancel from every
difference anyway.

This is the PyTorch counterpart of
``porousfreezethaw_tpu/models/freezing/delta.py``; the CUDA delta kernel
(``csrc/delta_g.cu``) evaluates the same expansion term by term.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.grid import GridGeometry
from . import physics
from .equation import CalcMode, _neighbor, _X, _Y, _Z, dirichlet_at, make_rhs
from .parameters import FreezingParams


def _tanh(x):
    """exp-based tanh, kept instead of torch.tanh so that the rounding is
    the JAX package's and the CUDA kernel's (see physics.dphf_du)."""
    e = torch.exp(-2.0 * torch.abs(x))
    t = (1.0 - e) / (1.0 + e)
    return torch.where(x < 0, -t, t)


def _dsshape(x, dx, prm: FreezingParams, c: physics.Coeffs):
    """sshape(x+dx) - sshape(x), exact on the mid branch."""
    xs = x - prm.p_eps0
    x_n = x + dx
    dmid = (c.eps2_3 * dx * (2.0 * xs + dx)
            - c.eps3_2 * dx * (3.0 * xs * xs + 3.0 * xs * dx + dx * dx))
    both_mid = ((x > prm.p_eps0) & (x < prm.p_eps1)
                & (x_n > prm.p_eps0) & (x_n < prm.p_eps1))
    direct = physics.sshape(x_n, prm, c) - physics.sshape(x, prm, c)
    return torch.where(both_mid, dmid, direct)


def compute_rhs_delta(mode: CalcMode, prm: FreezingParams,
                      coeffs: physics.Coeffs, geom: GridGeometry,
                      n: Dict[str, torch.Tensor]):
    """(Gu, Gp) = f(w + d) - f(w) from center values and the 6 neighbors
    of the old fields u, p, gl and the increments a (= d_u), b (= d_p).
    All entries of ``n`` share one shape; names: u, uxm, uxp, uym, uyp,
    uzm, uzp and likewise for p, gl, a, b.  gl is static (d_gl = 0)."""
    inv_h1, inv_h2, inv_h3 = geom.inv_h
    h1_2, h2_2, h3_2 = inv_h1**2, inv_h2**2, inv_h3**2
    h1d2, h2d2, h3d2 = 0.5 * inv_h1, 0.5 * inv_h2, 0.5 * inv_h3
    u, p, gl = n["u"], n["p"], n["gl"]
    a, b = n["a"], n["b"]
    wind = physics.water_indicator(gl, prm)
    um = u - prm.u_star

    lam_p_slope = prm.ice_lambda - prm.water_lambda
    rho_p_slope = prm.ice_rho - prm.water_rho
    cp_p_slope = prm.ice_cp - prm.water_cp

    def diffusion_parts():
        """(D_old, dD) = div(lam grad u) old value and exact increment."""
        D_old = None
        dD = None
        for w_ax, suf in ((h1_2, "x"), (h2_2, "y"), (h3_2, "z")):
            for sgn in ("m", "p"):
                f = suf + sgn
                pbar = 0.5 * (p + n["p" + f])
                gbar = 0.5 * (gl + n["gl" + f])
                lam_o = physics.lam(pbar, gbar, prm)
                du_o = n["u" + f] - u
                da = n["a" + f] - a
                bbar = 0.5 * (b + n["b" + f])
                lamp = (1.0 - gbar) * lam_p_slope
                fo = w_ax * (lam_o * du_o)
                fd = w_ax * (lam_o * da + bbar * lamp * (du_o + da))
                D_old = fo if D_old is None else D_old + fo
                dD = fd if dD is None else dD + fd
        return D_old, dD

    rho_o = physics.rho(p, gl, prm)
    drho = b * ((1.0 - gl) * rho_p_slope)
    rho_n = rho_o + drho
    cp_o = physics.cp(p, gl, prm)
    dcp = b * ((1.0 - gl) * cp_p_slope)
    cp_n = cp_o + dcp

    D_old, dD = diffusion_parts()

    if mode == CalcMode.TEMP:
        # --- model 2: du = div(lam grad u) / (rho (cp - L phf'(u))) ---
        x = prm.gamma * um
        tx = _tanh(x)
        td = _tanh(prm.gamma * a)
        # addition theorem, except where (1 + tx*td) cancels (large
        # opposite-sign arguments — saturated region, where the direct
        # difference of two bounded tanh values is well-conditioned)
        den = 1.0 + tx * td
        dtanh = torch.where(den > 0.5,
                          td * (1.0 - tx * tx)
                          / torch.clamp_min(den, 0.25),
                          _tanh(x + prm.gamma * a) - tx)
        tx_n = tx + dtanh
        sech2_o = 1.0 - tx * tx
        dsech2 = -dtanh * (tx_n + tx)
        dpdu_o = -0.5 * prm.gamma * sech2_o * wind
        ddpdu = -0.5 * prm.gamma * dsech2 * wind
        dpdu_n = dpdu_o + ddpdu
        denom_o = rho_o * (cp_o - prm.L * dpdu_o)
        ddenom = (drho * (cp_o - prm.L * dpdu_o)
                  + rho_n * (dcp - prm.L * ddpdu))
        denom_n = denom_o + ddenom
        du_o = D_old / denom_o
        ddu = (dD * denom_o - D_old * ddenom) / (denom_n * denom_o)
        ddp = ddpdu * du_o + dpdu_n * ddu
        return ddu, ddp

    # --- models 0/1 (+frozen-u 10/11) ---
    lap_old = None
    dlap = None
    for w_ax, suf in ((h1_2, "x"), (h2_2, "y"), (h3_2, "z")):
        for sgn in ("m", "p"):
            f = suf + sgn
            lo = w_ax * (n["p" + f] - p)
            ld = w_ax * (n["b" + f] - b)
            lap_old = lo if lap_old is None else lap_old + lo
            dlap = ld if dlap is None else dlap + ld

    # double-well g(p) = p(1-p)(p-1/2) = -p^3 + 1.5 p^2 - 0.5 p
    A = coeffs.xi_2_inv_a
    g_o = p * (1.0 - p) * (p - 0.5)
    gp = (3.0 - 3.0 * p) * p - 0.5           # g'(p)
    dg = b * (gp + b * (1.5 - 3.0 * p) - b * b)

    if mode in (CalcMode.GRADP, CalcMode.GRADP_FROZEN_U):
        B = prm.b * prm.alpha * prm.mu
        qx = h1d2 * (n["pxp"] - n["pxm"])
        qy = h2d2 * (n["pyp"] - n["pym"])
        qz = h3d2 * (n["pzp"] - n["pzm"])
        dx_ = h1d2 * (n["bxp"] - n["bxm"])
        dy_ = h2d2 * (n["byp"] - n["bym"])
        dz_ = h3d2 * (n["bzp"] - n["bzm"])
        S_o = qx * qx + qy * qy + qz * qz
        dS = (dx_ * (2.0 * qx + dx_) + dy_ * (2.0 * qy + dy_)
              + dz_ * (2.0 * qz + dz_))
        r_o = torch.sqrt(S_o)
        r_n = torch.sqrt(S_o + dS)
        dgn = dS / (r_o + r_n + 1e-30)
        gn_o = r_o + physics.EPS_REGULARIZATION
        gn_n = gn_o + dgn
        R_old = A * g_o - B * gn_o * um
        dR = A * dg - B * (dgn * um + gn_n * a)
    else:
        C = coeffs.xi_inv_b_sqrt_a2 * prm.alpha * prm.mu
        s1_o = physics.sshape(p, prm, coeffs)
        s2_o = physics.sshape(1.0 - p, prm, coeffs)
        ds1 = _dsshape(p, b, prm, coeffs)
        ds2 = _dsshape(1.0 - p, -b, prm, coeffs)
        s1_n = s1_o + ds1
        s2_n = s2_o + ds2
        pq_o = p * (1.0 - p)
        dpq = b * (1.0 - 2.0 * p - b)
        m_o = torch.clamp_min(pq_o, 0.0)
        m_n = torch.clamp_min(pq_o + dpq, 0.0)
        dm = torch.where((pq_o > 0) & (pq_o + dpq > 0), dpq, m_n - m_o)
        # telescoped product difference of s1*s2*m*(u-u*)
        dT = (ds1 * s2_o * m_o * um + s1_n * ds2 * m_o * um
              + s1_n * s2_n * dm * um + s1_n * s2_n * m_n * a)
        R_old = A * g_o - C * s1_o * s2_o * m_o * um
        dR = A * dg - C * dT

    inv_alpha_wind = wind / prm.alpha
    dp_old = (lap_old + R_old) * inv_alpha_wind
    ddp = (dlap + dR) * inv_alpha_wind

    if mode in (CalcMode.GRADP_FROZEN_U, CalcMode.SIGMAP_FROZEN_U):
        return torch.zeros_like(ddp), ddp

    X_o = D_old / rho_o
    dX = (dD * rho_o - D_old * drho) / (rho_n * rho_o)
    N_o = X_o + prm.L * dp_old
    dN = dX + prm.L * ddp
    ddu = (dN * cp_o - N_o * dcp) / (cp_n * cp_o)
    return ddu, ddp


def dirichlet_step(t1: float, ti: float, prm: FreezingParams,
                   dtype: torch.dtype) -> tuple:
    """(D(t1), D(ti) - D(t1)) at the field precision: the old u ghost and
    the increment ghost of the Dirichlet top (the difference is formed in
    the field dtype, as the JAX package forms it)."""
    d1 = dirichlet_at(t1, prm, dtype)
    di = dirichlet_at(ti, prm, dtype)
    if dtype == torch.float32:
        return d1, float(np.float32(di) - np.float32(d1))
    return d1, di - d1


def g_rhs(mode: CalcMode, params: FreezingParams, coeffs: physics.Coeffs,
          geom: GridGeometry, w, d, D1: float, dD: float) -> torch.Tensor:
    """G = f(w + d) - f(w) over (u, p), of shape (2,) + geom.shape, with
    the Dirichlet top given by its ghost values: ``D1`` for the old u and
    ``dD`` for the u increment.  ``w`` holds (u, p, gl) and ``d`` the
    increments (a, b) of (u, p); every other boundary is the mirror."""
    n = {}
    for nm, f, top in (("u", w[0], D1), ("p", w[1], None), ("gl", w[2], None),
                       ("a", d[0], dD), ("b", d[1], None)):
        n[nm] = f
        n[nm + "xm"] = _neighbor(f, _X, -1)
        n[nm + "xp"] = _neighbor(f, _X, +1)
        n[nm + "ym"] = _neighbor(f, _Y, -1)
        n[nm + "yp"] = _neighbor(f, _Y, +1)
        n[nm + "zm"] = _neighbor(f, _Z, -1)
        n[nm + "zp"] = _neighbor(f, _Z, +1, top)
    Gu, Gp = compute_rhs_delta(mode, params, coeffs, geom, n)
    return torch.stack([Gu, Gp])


def make_g_rhs(geom: GridGeometry, params: FreezingParams, calc_mode: int):
    """Plain evaluation of the increment form:

        g(t1, ti, w, d) -> G  of shape (2,) + geom.shape

    ``w`` is the full (3, n3, n2, n1) state at the step start (stage-1
    time ``t1``), ``d`` the (2, n3, n2, n1) increment of the dynamic
    variables at stage time ``ti``; G = f(ti, w + d) - f(t1, w) over
    (u, p).  Boundary handling matches make_rhs: mirror everywhere,
    Dirichlet top on u (old ghost D(t1), increment ghost D(ti) - D(t1))."""
    mode = CalcMode(calc_mode)
    coeffs = physics.Coeffs.of(params)

    def g(t1, ti, w, d):
        D1, dD = dirichlet_step(float(t1), float(ti), params, w.dtype)
        return g_rhs(mode, params, coeffs, geom, w, d, D1, dD)

    return g


class TorchDeltaAttempt:
    """Increment-form Merson attempt with the plain ``g`` and ``make_rhs``:
    the analog of the JAX package's ``XlaDeltaAttempt`` and the oracle of
    the algebra the CUDA ``DeltaAttempt`` kernels fuse
    (ops/cuda/stencil.py).  Runs on any device and dtype over the
    ``(3, n3, n2, n1)`` state; implements ``merson_solve``'s
    ``attempt_fn`` protocol."""

    def __init__(self, geom: GridGeometry, params: FreezingParams,
                 calc_mode: int, device: torch.device | str):
        self._g = make_g_rhs(geom, params, calc_mode)
        self._rhs = make_rhs(geom, params, calc_mode, device)

    def pack(self, y):
        return y

    def _stages(self, t, h, y):
        """The five stages on ``y``: (h, K1, G4, G5, eps)."""
        g = self._g
        K1 = self._rhs(t, y)[:2]
        hc = torch.tensor(h, dtype=y.dtype, device=y.device)
        G2 = g(t, t + h / 3, y, hc * (1.0 / 3.0) * K1)
        G3 = g(t, t + h / 3, y, hc * ((1.0 / 3.0) * K1 + (1.0 / 6.0) * G2))
        G4 = g(t, t + h / 2, y, hc * (0.5 * K1 + 0.375 * G3))
        G5 = g(t, t + h, y, hc * (K1 - 1.5 * G3 + 2.0 * G4))
        eps = torch.amax(torch.abs(-0.9 * G3 + 0.8 * G4 - 0.1 * G5))
        return hc, K1, G4, G5, eps.reshape(1)

    def attempt(self, t, h, y):
        hc, K1, G4, G5, eps = self._stages(t, h, y)
        y_spec = (y[:2] + hc * K1
                  + (hc / 3.0) * (2.0 * G4 + 0.5 * G5))
        return (y, y_spec), eps

    def commit(self, carry_spec, accept: bool):
        y, y_spec = carry_spec
        if not accept:
            return y
        return torch.cat([y_spec.to(y.dtype), y[2:]])

    def unpack(self, y):
        return y


def two_sum(hi, lo, dy):
    """The compensated commit's sum (XlaDeltaAttemptComp.commit): with
    ``t1 = dy + lo``, returns ``s = fl(hi + t1)`` and its exact rounding
    error ``err`` (Knuth's TwoSum), so that ``s + err == hi + t1``."""
    t1 = dy + lo
    s = hi + t1
    bb = s - hi
    err = (hi - (s - bb)) + (t1 - bb)
    return s, err


class TorchDeltaAttemptComp(TorchDeltaAttempt):
    """TorchDeltaAttempt with a compensated (double-f32) commit: the analog
    of the JAX package's ``XlaDeltaAttemptComp`` and the oracle of the CUDA
    ``DeltaAttemptComp``.  The packed state is ``(5, n3, n2, n1)`` =
    [u, p, gl, u_lo, p_lo]; the stages read [u, p, gl] and the commit adds
    the increment dy into (hi, lo) by :func:`two_sum`, so that hi + lo
    tracks the exact trajectory to about ulp^2.  ``unpack`` keeps the lo
    planes; strip them with ``y[:3]`` for output."""

    def pack(self, y):
        if y.shape[0] == 5:       # already packed: merson_solve packs on
            return y              # every call, and the lo planes carry
        return torch.cat([y, torch.zeros_like(y[:2])])

    def attempt(self, t, h, y5):
        hc, K1, G4, G5, eps = self._stages(t, h, y5[:3])
        dy = hc * K1 + (hc / 3.0) * (2.0 * G4 + 0.5 * G5)
        return (y5, dy), eps

    def commit(self, carry_spec, accept: bool):
        y5, dy = carry_spec
        if not accept:
            return y5
        s, err = two_sum(y5[:2], y5[3:], dy)
        return torch.cat([s, y5[2:3], err])
