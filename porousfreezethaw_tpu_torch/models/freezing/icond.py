"""Formula-driven initial conditions.

The reference evaluates each variable's icond formula cell by cell with the
expression evaluator, with variables ``x,y,z`` (physical coordinates),
``_x,_y,_z`` (relative (0,1) coordinates), all model parameters, batch loop
variables, and — via multi-pass retry on unresolved names — the *other
variables'* already-computed initial values (``intertrack.c:1831-2020``).

Here each formula is parsed once and evaluated vectorized over the full
coordinate grid; the multi-pass dependency resolution keeps the same
semantics (a formula referencing a not-yet-initialized variable fails to
bind and is retried next pass until no progress is made).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...config.expression import Expression, ExpressionError
from ...core import tracing
from ...core.grid import GridGeometry
from .parameters import FreezingParams, VARIABLES


class ICondError(ValueError):
    pass


@tracing.span("pft.setup.icond")
def build_initial_conditions(
    geom: GridGeometry,
    params: FreezingParams,
    formulas: Dict[str, str],
    loop_vars: Optional[Dict[str, float]] = None,
    dtype=np.float64,
) -> np.ndarray:
    """Evaluate icond formulas for all variables; returns (3, n3, n2, n1).

    Missing formulas raise — the reference requires an icond for every
    variable (empty formula -> syntax error -> abort).
    """
    tracing.annotate(cells=geom.num_cells)
    z, y, x = geom.cell_centers()
    env: Dict[str, np.ndarray] = {
        "x": x[None, None, :], "y": y[None, :, None], "z": z[:, None, None],
        "_x": (x / geom.L1)[None, None, :],
        "_y": (y / geom.L2)[None, :, None],
        "_z": (z / geom.L3)[:, None, None],
        "L1": geom.L1, "L2": geom.L2, "L3": geom.L3,
    }
    env.update(params.as_dict())
    # batch loop variables i1..i20 default to 1 (intertrack.c:1893-1901)
    for q in range(20):
        env[f"i{q+1}"] = 1.0
    for name, value in (loop_vars or {}).items():
        env[name] = float(value)

    exprs: Dict[str, Expression] = {}
    for var in VARIABLES:
        if var not in formulas:
            raise ICondError(f"no initial condition formula for variable {var!r}")
        try:
            exprs[var] = Expression(formulas[var])
        except ExpressionError as exc:
            raise ICondError(
                f"Syntax error in initial condition formula for {var}: {exc}")

    fields: Dict[str, np.ndarray] = {}
    remaining: List[str] = list(VARIABLES)
    pass_no = 1
    while remaining:
        progress = []
        errors = {}
        for var in remaining:
            try:
                value = exprs[var].evaluate({**env, **fields})
            except ExpressionError as exc:
                errors[var] = str(exc)
                continue
            fields[var] = np.broadcast_to(
                np.asarray(value, dtype=dtype), geom.shape).copy()
            progress.append(var)
        remaining = [v for v in remaining if v not in progress]
        if remaining and not progress:
            msgs = "; ".join(f"{v}: {errors[v]}" for v in remaining)
            raise ICondError(
                f"unresolvable initial condition formula(s) after pass "
                f"{pass_no}: {msgs}")
        pass_no += 1

    return np.stack([fields[v] for v in VARIABLES])
