"""Plain reference of the intertrack freezing model: the case's initial
state, the right-hand side of each calc mode, one Runge-Kutta-Merson
attempt and the step controller.

A frozen copy of the model's equations (the reference application's
``equation.c:341-421`` cell physics and ``equation.c:566-884`` stencils,
``RK_MPI_SAsolver.c`` step control), written in plain PyTorch on the
state ``(3, n3, n2, n1)`` = (u, p, gl) x (z, y, x).  It imports nothing
of the program under test: every constant comes from the configuration's
JSON file and every coordinate from its grid.

Boundaries: a neighbour outside the domain is the cell itself (zero flux,
the finite-volume mirror rule), except the temperature's +z neighbour,
which is the Dirichlet top value ``top_temp1`` before
``phase_switch_time`` and ``top_temp2`` after.  Each face flux is
computed once and added to the two cells it joins; the conductivity at a
face is the material blend at the arithmetic mean of p and gl there.

The default width is float64, the reference application's own.  Another
``dtype`` computes every field operation in that width (the lower-
precision control); the controller's t, h and eps stay Python floats.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EPS_REG = 1e-10

# calc modes: 0 GradP, 1 SigmaP1-P, 2 Temp, 10/11 the first two with u
# frozen in time
MODES = (0, 1, 2, 10, 11)


class Followed(NamedTuple):
    """The end of a followed stretch of attempts."""

    y: torch.Tensor        # (3, n3, n2, n1), the reference's width
    t: float
    h: float               # the h of the next attempt
    accepted: int
    attempts: int
    finished: bool
    status: int            # 0, or -4 for a failed NaN backoff
    steps_h: list          # the h of each accepted step


class Replayed(NamedTuple):
    """The reference's run of a given sequence of accepted steps."""

    y: torch.Tensor        # (3, n3, n2, n1), the reference's width
    eps: list              # the error estimate of each step


class FreezingReference:
    """The model of one configuration (its JSON dict) on ``device`` in
    ``dtype``."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        self.prm = dict(cfg["physics"])
        if self.prm.get("u_noise_amp", 0.0) != 0.0:
            raise ValueError("the reference has no temperature noise field")
        g = cfg["grid"]
        self.L = (float(g["L1"]), float(g["L2"]), float(g["L3"]))
        self.n = (int(g["n1"]), int(g["n2"]), int(g["n3"]))
        self.mode = int(cfg["calc_mode"])
        if self.mode not in MODES:
            raise ValueError(f"unknown calc mode {self.mode}")
        self.device = torch.device(device)
        self.dtype = dtype
        n1, n2, n3 = self.n
        L1, L2, L3 = self.L
        # 1/h^2 and 1/(2h) by tensor axis (z, y, x)
        inv_h = (n3 / L3, n2 / L2, n1 / L1)
        self.c2 = tuple(v * v for v in inv_h)
        self.cd = tuple(0.5 * v for v in inv_h)
        self._static = None

    @property
    def shape(self):
        n1, n2, n3 = self.n
        return (n3, n2, n1)

    # ------------------------------------------------------------------
    # the initial state
    # ------------------------------------------------------------------

    def centers(self):
        """Cell-centre coordinates (z, y, x), float64 numpy."""
        n1, n2, n3 = self.n
        L1, L2, L3 = self.L
        z = (np.arange(n3) + 0.5) * (L3 / n3)
        y = (np.arange(n2) + 0.5) * (L2 / n2)
        x = (np.arange(n1) + 0.5) * (L1 / n1)
        return z, y, x

    def initial_state(self, icond, bed_file: str) -> torch.Tensor:
        """The state at t = 0 in float64 on the device: ``icond(x, y, z,
        prm)`` (the configuration's formulas on broadcast numpy arrays,
        ``prm`` its constants with the domain's L1, L2 and L3) for
        u, p and gl, then gl raised to the profile of every glass ball of
        ``bed_file`` (unit-box centres, scaled by ``beads_scaling`` and
        shifted by ``beads_offset_*``):
        ``0.5 (1 - tanh(0.5/xi_gl (|x - c| + 1e-10 - R)))``."""
        z, y, x = self.centers()
        prm = self.prm
        L1, L2, L3 = self.L
        fields = icond(x[None, None, :], y[None, :, None], z[:, None, None],
                       dict(prm, L1=L1, L2=L2, L3=L3))
        y0 = torch.empty((3,) + self.shape, dtype=torch.float64,
                         device=self.device)
        for i, f in enumerate(fields):
            y0[i] = torch.from_numpy(np.array(f, dtype=np.float64))
        balls = read_bed(bed_file)
        balls = balls * prm["beads_scaling"] + np.array(
            [prm["beads_offset_x"], prm["beads_offset_y"],
             prm["beads_offset_z"]])
        self._glass(y0[2], balls, z, y, x)
        return y0

    def _glass(self, gl, balls, z, y, x):
        """Raise ``gl`` to each ball's profile.  Beyond 40 xi_gl from a
        ball's surface tanh is 1 to the last bit of a double, so the box
        of that reach around each ball gives the all-cells result."""
        prm = self.prm
        R, k = prm["ball_radius"], 0.5 / prm["xi_gl"]
        reach = R + 40.0 * prm["xi_gl"]
        dev = gl.device
        zt, yt, xt = (torch.as_tensor(a, device=dev) for a in (z, y, x))
        for c in balls:
            kz = np.searchsorted(z, [c[2] - reach, c[2] + reach])
            ky = np.searchsorted(y, [c[1] - reach, c[1] + reach])
            kx = np.searchsorted(x, [c[0] - reach, c[0] + reach])
            if kz[0] >= kz[1] or ky[0] >= ky[1] or kx[0] >= kx[1]:
                continue
            d = torch.sqrt(
                (xt[kx[0]:kx[1]][None, None, :] - c[0]) ** 2
                + (yt[ky[0]:ky[1]][None, :, None] - c[1]) ** 2
                + (zt[kz[0]:kz[1]][:, None, None] - c[2]) ** 2) + 1e-10
            prof = 0.5 * (1.0 - torch.tanh(k * (d - R)))
            box = gl[kz[0]:kz[1], ky[0]:ky[1], kx[0]:kx[1]]
            torch.maximum(box, prof, out=box)

    # ------------------------------------------------------------------
    # the right-hand side
    # ------------------------------------------------------------------

    def prepare(self, gl: torch.Tensor) -> None:
        """The terms that depend on the glass field alone (gl is static:
        its time derivative is 0), in the reference's width."""
        prm, dt = self.prm, self.dtype
        gl = gl.to(self.device, dt)
        one = 1.0 - gl
        s = {"gl": gl,
             "wi": torch.clamp_min(1.0 - prm["zeta"] * gl, 0.0),
             # rho = R0 + R1 p, cp = C0 + C1 p: the blends are linear in p
             "R0": gl * prm["glass_rho"] + one * prm["water_rho"],
             "R1": one * (prm["ice_rho"] - prm["water_rho"]),
             "C0": gl * prm["glass_cp"] + one * prm["water_cp"],
             "C1": one * (prm["ice_cp"] - prm["water_cp"])}
        # face conductivity lam(P, G) = A + B P at the face mean G of gl,
        # P = (p_i + p_j) / 2, with 1/h^2 of the axis folded in
        faces = []
        for ax in range(3):
            n = gl.shape[ax]
            G = 0.5 * (gl.narrow(ax, 0, n - 1) + gl.narrow(ax, 1, n - 1))
            A = (G * prm["glass_lambda"] + (1.0 - G) * prm["water_lambda"]
                 ) * self.c2[ax]
            B = ((1.0 - G) * (prm["ice_lambda"] - prm["water_lambda"])
                 * (0.5 * self.c2[ax]))
            faces.append((A, B))
        s["faces"] = faces
        # the top face (+z of the last plane): the mirror p and gl, so
        # lam(p, gl) of the top cell
        gtop = gl[-1]
        s["top"] = ((gtop * prm["glass_lambda"]
                     + (1.0 - gtop) * prm["water_lambda"]) * self.c2[0],
                    (1.0 - gtop) * (prm["ice_lambda"] - prm["water_lambda"])
                    * self.c2[0])
        self._static = s

    def top(self, t: float) -> float:
        prm = self.prm
        return (prm["top_temp1"] if t < prm["phase_switch_time"]
                else prm["top_temp2"])

    def div_lambda_grad_u(self, t, u, p):
        s = self._static
        out = torch.zeros_like(u)
        for ax, (A, B) in enumerate(s["faces"]):
            n = u.shape[ax]
            lo_u, hi_u = u.narrow(ax, 0, n - 1), u.narrow(ax, 1, n - 1)
            lo_p, hi_p = p.narrow(ax, 0, n - 1), p.narrow(ax, 1, n - 1)
            flux = torch.addcmul(A, B, lo_p + hi_p) * (hi_u - lo_u)
            out.narrow(ax, 0, n - 1).add_(flux)
            out.narrow(ax, 1, n - 1).sub_(flux)
        At, Bt = s["top"]
        out[-1] += torch.addcmul(At, Bt, p[-1]) * (self.top(t) - u[-1])
        return out

    def _double_well(self, p):
        prm = self.prm
        return (prm["a"] / (prm["xi"] * prm["xi"])) * p * (1.0 - p) * (
            p - 0.5)

    def _sshape(self, x):
        prm = self.prm
        e0, e1 = prm["p_eps0"], prm["p_eps1"]
        d = e1 - e0
        xs = x - e0
        mid = xs * xs * (3.0 / (d * d) - (2.0 / (d * d * d)) * xs)
        return torch.where(x <= e0, torch.zeros_like(mid),
                           torch.where(x >= e1, torch.ones_like(mid), mid))

    def rhs(self, t: float, u: torch.Tensor, p: torch.Tensor):
        """(du/dt, dp/dt) at time ``t``; gl's derivative is 0."""
        s, prm, mode = self._static, self.prm, self.mode
        us = prm["u_star"]
        if mode == 2:
            # the algebraic phase field's slope: -gamma/2 sech^2(gamma
            # (u - u*)), in the water fraction
            x = (u - us).mul_(prm["gamma"]).abs_()
            e = torch.exp(x.neg_())
            sech = (2.0 * e) / (1.0 + e * e)
            dp_du = (sech * sech).mul_(-0.5 * prm["gamma"]).mul_(s["wi"])
            rho = torch.addcmul(s["R0"], s["R1"], p)
            cp = torch.addcmul(s["C0"], s["C1"], p)
            denom = rho.mul_(cp.add_(dp_du, alpha=-prm["L"]))
            du = self.div_lambda_grad_u(t, u, p).div_(denom)
            return du, dp_du.mul_(du)
        # modes 0/1 (10/11: u frozen)
        lap = torch.zeros_like(p)
        grad2 = torch.zeros_like(p) if mode in (0, 10) else None
        for ax in range(3):
            n = p.shape[ax]
            dp = p.narrow(ax, 1, n - 1) - p.narrow(ax, 0, n - 1)
            lap.narrow(ax, 0, n - 1).add_(dp, alpha=self.c2[ax])
            lap.narrow(ax, 1, n - 1).sub_(dp, alpha=self.c2[ax])
            if grad2 is not None:
                # the central difference p_{i+1} - p_{i-1} (mirror ends)
                cen = torch.zeros_like(p)
                cen.narrow(ax, 0, n - 1).add_(dp)
                cen.narrow(ax, 1, n - 1).add_(dp)
                grad2.addcmul_(cen, cen, value=self.cd[ax] ** 2)
        du_rel = u - us
        if grad2 is not None:
            gnorm = grad2.sqrt_().add_(EPS_REG)
            react = self._double_well(p) - (
                prm["b"] * prm["alpha"] * prm["mu"]) * gnorm * du_rel
        else:
            pq = p * (1.0 - p)
            c = prm["b"] * math.sqrt(0.5 * prm["a"]) / prm["xi"]
            react = self._double_well(p) - (
                c * prm["alpha"] * prm["mu"] * self._sshape(p)
                * self._sshape(1.0 - p) * torch.clamp_min(pq, 0.0) * du_rel)
        dp_dt = (lap.add_(react)).div_(prm["alpha"]).mul_(s["wi"])
        if mode in (10, 11):
            return torch.zeros_like(u), dp_dt
        rho = torch.addcmul(s["R0"], s["R1"], p)
        cp = torch.addcmul(s["C0"], s["C1"], p)
        du = (self.div_lambda_grad_u(t, u, p).div_(rho)
              .add_(dp_dt, alpha=prm["L"]).div_(cp))
        return du, dp_dt

    # ------------------------------------------------------------------
    # Runge-Kutta-Merson
    # ------------------------------------------------------------------

    def attempt(self, t: float, h: float, u, p):
        """One Merson attempt from (u, p) at t with step h: the error
        estimate (the max norm of 0.2 K1 - 0.9 K3 + 0.8 K4 - 0.1 K5 over
        u and p, NaN-propagating) and the candidate (u, p)."""
        f = self.rhs
        h3, h6, h8 = h / 3.0, h / 6.0, h / 8.0
        k1 = f(t, u, p)
        k2 = f(t + h3, *(torch.add(y, k, alpha=h3) for y, k in zip((u, p), k1)))
        s3 = [a + b for a, b in zip(k1, k2)]
        del k2
        k3 = f(t + h3, *(torch.add(y, k, alpha=h6) for y, k in zip((u, p), s3)))
        del s3
        s4 = [torch.add(a, b, alpha=3.0) for a, b in zip(k1, k3)]
        k4 = f(t + h / 2.0,
               *(torch.add(y, k, alpha=h8) for y, k in zip((u, p), s4)))
        del s4
        s5 = [(0.5 * a).add_(b, alpha=-1.5).add_(c, alpha=2.0)
              for a, b, c in zip(k1, k3, k4)]
        k5 = f(t + h, *(torch.add(y, k, alpha=h) for y, k in zip((u, p), s5)))
        del s5
        err = None
        new = []
        for y, a, b, c, d in zip((u, p), k1, k3, k4, k5):
            e = torch.amax(torch.abs(
                (0.2 * a).add_(b, alpha=-0.9).add_(c, alpha=0.8)
                .add_(d, alpha=-0.1)))
            err = e if err is None else torch.maximum(err, e)
            new.append(torch.add(y, (0.5 * (a + d)).add_(c, alpha=2.0),
                                 alpha=h3))
        return float(err), new

    def follow(self, y: torch.Tensor, *, t: float, h: float, tf: float,
               attempts: int, delta: float, h_min: float = 0.0,
               growth_min: float = 0.0, handle_nan: bool = False,
               finished: bool = False) -> Followed:
        """``attempts`` Merson attempts from the state ``y`` at t with the
        next step h, under the reference's step control: accept when
        eps < delta or |h| < h_min; the next h is 0.8 (delta/eps)^0.2 h
        (2 h at eps = 0 or NaN), at least ``growth_min`` h on an accepted
        step where growth_min > 1; a NaN eps under ``handle_nan`` commits
        nothing and takes h/10; the last step is trimmed to ``tf``."""
        self.prepare(y[2])
        u = y[0].to(self.device, self.dtype).clone()
        p = y[1].to(self.device, self.dtype).clone()
        accepted = 0
        status = 0
        n = 0
        steps_h = []
        while n < attempts:
            n += 1
            eps, (u_new, p_new) = self.attempt(t, h, u, p)
            nan = handle_nan and not math.isfinite(eps)
            accept = eps < delta or abs(h) < h_min
            new_h = step_factor(eps, delta, growth_min) * h
            upd = accept and not nan
            t_new = t + h if upd else t
            if upd:
                u, p = u_new, p_new
                accepted += 1
                steps_h.append(h)
            left = tf - t
            too_small = abs(h / left) < 1e-11 if left != 0 else False
            next_finish = abs(tf - t_new) <= abs(new_h)
            done = upd and finished
            if nan and too_small:
                status = -4
                t = t_new
                break
            if nan:
                h_next = h / 10.0
            elif upd and next_finish:
                h_next = tf - t_new
            else:
                h_next = new_h
            finished = False if nan else (next_finish if upd else False)
            t, h = t_new, h_next
            if done:
                break
        out = torch.stack([u, p, self._static["gl"]])
        return Followed(out, t, h, accepted, n, bool(finished), status,
                        steps_h)

    def replay(self, y: torch.Tensor, t: float, steps_h) -> Replayed:
        """The accepted steps of sizes ``steps_h``, one after another from
        the state ``y`` at ``t``: each step's error estimate and the
        state after the last."""
        self.prepare(y[2])
        u = y[0].to(self.device, self.dtype).clone()
        p = y[1].to(self.device, self.dtype).clone()
        eps = []
        for h in steps_h:
            e, (u, p) = self.attempt(t, float(h), u, p)
            eps.append(e)
            t = t + float(h)
        return Replayed(torch.stack([u, p, self._static["gl"]]), eps)


def step_factor(eps: float, delta: float, growth_min: float = 0.0) -> float:
    """The controller's factor on h after an attempt of error ``eps``:
    0.8 (delta/eps)^0.2, 2 at eps = 0 or NaN, at least ``growth_min`` on
    an accepted step where growth_min > 1."""
    fac = 0.8 * (delta / eps) ** 0.2 if eps > 0.0 else 2.0
    if growth_min > 1.0 and eps < delta:
        fac = max(fac, growth_min)
    return fac


def read_bed(path: str) -> np.ndarray:
    """The (n, 3) sphere centres of a bed file: one ``x y z`` a line."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                rows.append([float(v) for v in parts[:3]])
    if not rows:
        raise ValueError(f"no sphere centres in {path}")
    return np.asarray(rows, dtype=np.float64)
