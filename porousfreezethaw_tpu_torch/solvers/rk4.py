"""Fixed-step classic RK4 integrator (PyTorch).

The counterpart of ``porousfreezethaw_tpu/solvers/rk4.py``, the
reference's ``modules/RK_solver`` / ``modules/RK_csolver``
(``RK_solve(int steps, ...)``: a fixed number of classic fourth-order
steps at constant h; RK_solver.c:77-180).  The state is a tensor or a
dict of tensors; t and h are Python floats (f64), and each leaf takes them
rounded to its dtype as a kernel argument.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

from .merson import _axpy, _leaves


def rk4_step(rhs: Callable, t: float, y, h: float):
    """One classic RK4 step (tableau from RK_solver.c:130-180)."""
    h2, h3, h6 = h / 2, h / 3, h / 6
    K1 = rhs(t, y)
    K2 = rhs(t + h2, _axpy(h2, K1, y))
    K3 = rhs(t + h2, _axpy(h2, K2, y))
    K4 = rhs(t + h, _axpy(h, K3, y))
    y_new = _leaves(
        lambda yi, k1, k2, k3, k4: yi + h6 * (k1 + k4) + h3 * (k2 + k3),
        y, K1, K2, K3, K4)
    return t + h, y_new


def rk4_solve(rhs: Callable, t0: float, y0, h: float,
              steps: int) -> Tuple[float, Any]:
    """Run ``steps`` fixed RK4 steps; returns (t, y)."""
    t, y = float(t0), y0
    for _ in range(steps):
        t, y = rk4_step(rhs, t, y, float(h))
    return t, y
