"""Dormand-Prince 5(4) adaptive integrator (the "ode45 twin"), PyTorch.

The counterpart of ``porousfreezethaw_tpu/solvers/dopri.py``.  The
reference validates its C DEM simulator against a MATLAB twin driven by
``ode45`` (Dormand-Prince) with RelTol/AbsTol control
(``apps/sphere-collider-MATLAB/spheres.m:38-40``); this is that second,
independent integrator for cross-validating the Merson solver: the
classic DP5(4) FSAL pair with MATLAB-style mixed error control

    err = max_i |e_i| / max(AbsTol, RelTol * max(|y_i|, |y_new_i|))
    accept iff err <= 1;  h *= min(5, max(0.2, 0.9 * err^(-1/5)))

over a tensor or a dict of tensors.  As in the Merson controller, the
loop runs on the host with t, h and err as Python floats (f64) and one
device sync (err) per attempt.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from .merson import _leaves, _max_of_leaves

# Dormand-Prince tableau (Butcher coefficients)
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40)
_E = tuple(b5 - b4 for b5, b4 in zip(_B5, _B4))


class DopriResult(NamedTuple):
    t: float
    y: Any
    h: float
    steps: int
    steps_total: int


def _combine(y, Ks, coefs, h):
    """y + sum (h*c_i) K_i per leaf, accumulated in the tableau's order."""
    def leaf(yv, *kvs):
        acc = yv
        for c, kv in zip(coefs, kvs):
            acc = acc + (h * c) * kv
        return acc
    return _leaves(leaf, y, *Ks)


def _err_norm(Ks, y, y_new, h, threshold):
    def leaf(yv, nv, *kvs):
        e = torch.zeros_like(yv)
        for c, kv in zip(_E, kvs):
            e = e + c * kv
        scale = torch.clamp(torch.maximum(torch.abs(yv), torch.abs(nv)),
                            min=threshold)
        return torch.amax(torch.abs(h * e) / scale)
    return _max_of_leaves(_leaves(leaf, y, y_new, *Ks))


def dopri45_solve(rhs: Callable, t0: float, y0, t_final: float, h0: float,
                  *, rtol: float = 1e-6, atol: float = 1e-4,
                  max_step: float = math.inf,
                  max_steps: int = 2**62) -> DopriResult:
    """Integrate ``y' = rhs(t, y)`` from t0 to t_final."""
    t = float(t0)
    tf = float(t_final)
    direction = 1.0 if tf >= t else -1.0
    h0 = direction * min(abs(float(h0)), max_step)
    threshold = atol / rtol

    y = y0
    k1 = rhs(t, y)
    h = tf - t if abs(h0) > abs(tf - t) else h0
    steps = steps_total = 0
    done = False
    while not done and steps_total < max_steps:
        Ks = [k1]
        for s in range(1, 7):
            Ks.append(rhs(t + _C[s] * h, _combine(y, Ks, _A[s], h)))
        y_new = _combine(y, Ks, _B5, h)   # == stage-7 input (FSAL)
        err = float(_err_norm(Ks, y, y_new, h, threshold)) / rtol
        accept = err <= 1.0

        steps_total += 1
        if accept:
            t, y, k1 = t + h, y_new, Ks[6]
            steps += 1

        # err > 0 is False for a NaN err as in jnp.where: the factor is 5
        factor = 0.9 * err ** -0.2 if err > 0 else 5.0
        factor = min(max(factor, 0.2), 5.0)
        h_new = direction * min(abs(h * factor), max_step)
        # trim to the final time
        remaining = tf - t
        h = remaining if abs(h_new) > abs(remaining) else h_new
        done = accept and abs(remaining) <= 0.0
    return DopriResult(t=t, y=y, h=h, steps=steps, steps_total=steps_total)
