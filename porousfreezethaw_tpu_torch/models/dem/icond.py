"""DEM initial conditions (spheres_friction_angular.c:398-489).

The reference seeds libc rand() with time+rank; here a numpy RandomState
seed gives reproducible configurations (documented deviation — the
reference's initial jitter is itself run-to-run random).

A numpy-only copy of ``porousfreezethaw_tpu/models/dem/icond.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from .config import DEMConfig


def _state(cfg: DEMConfig, pos: np.ndarray) -> Dict[str, np.ndarray]:
    n = pos.shape[0]
    y = {"pos": pos, "vel": np.zeros((n, 3))}
    if cfg.angular:
        y["angvel"] = np.zeros((n, 3))
    return y


def icond_dense(cfg: DEMConfig, seed: Optional[int] = None
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Jittered-grid dense packing (spheres_friction_angular.c:454-489).
    Returns (state, color); color is the initial z coordinate."""
    rng = np.random.RandomState(seed)
    balls_per_row = int(math.floor(cfg.R / (2.5 * cfg.r)))
    distance = cfg.R / balls_per_row
    pos = np.zeros((cfg.n, 3))
    xi = yi = zi = 1
    for i in range(cfg.n):
        pos[i, 0] = (xi - 0.5) * distance + 0.25 * cfg.r * rng.random_sample()
        pos[i, 1] = (yi - 0.5) * distance + 0.25 * cfg.r * rng.random_sample()
        pos[i, 2] = cfg.h0 + (zi - 0.5) * distance + 0.25 * cfg.r * rng.random_sample()
        xi += 1
        if xi > balls_per_row:
            xi, yi = 1, yi + 1
            if yi > balls_per_row:
                yi, zi = 1, zi + 1
    return _state(cfg, pos), pos[:, 2].copy()


def icond_sparse(cfg: DEMConfig, seed: Optional[int] = None
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Random x-y, stacked z (spheres_friction_angular.c:430-452)."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((cfg.n, 3))
    pos[:, 0] = cfg.r + (cfg.R - 2 * cfg.r) * rng.random_sample(cfg.n)
    pos[:, 1] = cfg.r + (cfg.R - 2 * cfg.r) * rng.random_sample(cfg.n)
    pos[:, 2] = cfg.h0 + 2.0 * cfg.r * np.arange(cfg.n)
    return _state(cfg, pos), pos[:, 2].copy()


def icond_2spheres(cfg: DEMConfig) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Two-sphere head-on test case with gravity off
    (spheres_friction_angular.c:398-428) — the closed-form force oracle."""
    pos = np.zeros((2, 3))
    vel = np.zeros((2, 3))
    for i in range(2):
        pos[i] = [0.45 + 1.2 * cfg.r * i, 0.5, cfg.h0 + 5.0 * cfg.r * i]
    vel[1] = [0.0, 0.0, -1.0]
    y = {"pos": pos, "vel": vel}
    if cfg.angular:
        y["angvel"] = np.zeros((2, 3))
    return y, pos[:, 2].copy()
