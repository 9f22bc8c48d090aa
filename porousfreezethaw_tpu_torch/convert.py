"""Carry parameters and state across from the JAX package.

The two packages share no module (this one never imports JAX), so their
objects meet as plain Python and numpy values:

* ``params_from_reference(d)`` turns ``FreezingParams.as_dict()`` of the
  JAX package into this package's ``FreezingParams``;
* ``state_from_reference(w, t, h, steps, steps_total, device)`` turns a
  numpy ``(3, n3, n2, n1)`` state and the ``MersonState`` scalars into this
  package's ``MersonState``;
* ``dem_state_from_reference(y, t, h, steps, steps_total)`` does the same
  for a DEM state, a dict of ``(n, 3)`` arrays ({pos, vel[, angvel]}).

On disk the carrier is the NetCDF snapshot: every snapshot the JAX app
writes is a checkpoint this package's app resumes through
``set continue_series`` (``io/snapshots.py`` ``load_checkpoint``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .models.freezing.parameters import PARAM_NAMES, FreezingParams
from .solvers.merson import MersonState


def params_from_reference(d: Mapping[str, float]) -> FreezingParams:
    missing = [n for n in PARAM_NAMES if n not in d]
    if missing:
        raise KeyError(f"parameters missing: {missing}")
    return FreezingParams.from_dict(dict(d))


def state_from_reference(w, t, h, steps, steps_total,
                         device: torch.device | str,
                         dtype: Optional[torch.dtype] = None) -> MersonState:
    """``w`` is any array convertible by ``np.asarray`` (a numpy array, or
    a JAX array's host copy); ``dtype`` defaults to ``w``'s own float
    dtype.  The scalars are read as Python numbers (t, h as f64)."""
    arr = np.asarray(w)
    if arr.ndim != 4 or arr.shape[0] != 3:
        raise ValueError(f"state must be (3, n3, n2, n1), got {arr.shape}")
    if dtype is None:
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}.get(arr.dtype)
        if dtype is None:
            raise TypeError(f"unsupported state dtype {arr.dtype}")
    # a copy: the source may be a read-only view of another framework's
    # buffer
    y = torch.tensor(arr, dtype=dtype, device=device)
    return MersonState(t=float(t), h=float(h), y=y, steps=int(steps),
                       steps_total=int(steps_total))


def dem_state_from_reference(y: Mapping[str, object], t, h, steps,
                             steps_total, device: torch.device | str = "cpu",
                             dtype: Optional[torch.dtype] = None
                             ) -> MersonState:
    """``y`` maps 'pos', 'vel' and optionally 'angvel' to ``(n, 3)``
    arrays (numpy, or a JAX array's host copy); ``dtype`` defaults to each
    array's own float dtype.  The scalars are read as Python numbers."""
    keys = set(y)
    if not ({"pos", "vel"} <= keys <= {"pos", "vel", "angvel"}):
        raise ValueError(f"a DEM state has pos, vel[, angvel], got "
                         f"{sorted(keys)}")
    out = {}
    for k in ("pos", "vel", "angvel"):
        if k not in y:
            continue
        arr = np.asarray(y[k])
        if arr.ndim != 2 or arr.shape[1] != 3:
            raise ValueError(f"{k} must be (n, 3), got {arr.shape}")
        # a copy, as in state_from_reference
        out[k] = torch.tensor(arr, dtype=dtype, device=device)
    return MersonState(t=float(t), h=float(h), y=out, steps=int(steps),
                       steps_total=int(steps_total))
