"""Static glass-ball phase field construction.

The reference reads the DEM-produced sphere centers from a text file,
applies scaling/offsets, and writes a tanh phase-field profile around each
ball into the ``gl`` field, taking the pointwise maximum with the
formula-initialized field (``equation.c:458-530``).  This is the offline
coupling point between the DEM simulator and the freezing simulator
(``spheres_final_positions.txt``, README.md:103).

Here the whole construction is vectorized: one broadcast distance
computation over (cells x balls), then a max-reduce over balls.
"""

from __future__ import annotations

import numpy as np

from ...core.grid import GridGeometry
from .parameters import FreezingParams

MAX_BALLS_COUNT = 1000  # equation.c:34


def read_ball_positions(path: str, params: FreezingParams) -> np.ndarray:
    """Read raw ball centers and apply beads_scaling / beads_offset_*
    (equation.c:474-483).  Returns (n_balls, 3) array of (x, y, z)."""
    raw = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            raw.append([float(parts[0]), float(parts[1]), float(parts[2])])
            if len(raw) >= MAX_BALLS_COUNT:
                break
    if not raw:
        raise ValueError(f"no ball positions found in {path}")
    balls = np.asarray(raw, dtype=np.float64)
    balls = balls * params.beads_scaling + np.array(
        [params.beads_offset_x, params.beads_offset_y, params.beads_offset_z])
    return balls


def build_glass_field(geom: GridGeometry, params: FreezingParams,
                      balls: np.ndarray, gl_init: np.ndarray,
                      cutoff_xi: float = 18.0) -> np.ndarray:
    """Maximum of the formula-initialized field and the per-ball tanh
    profile  0.5 (1 - tanh(0.5/xi_gl (|x - c| - R)))  (equation.c:507-529).

    ``gl_init`` has shape (n3, n2, n1).  Euclidean distance carries the
    reference's +1e-10 regularization (equation.c:332-336).

    Each ball only touches cells within its bounding box of radius
    ``R + 2*cutoff_xi*xi_gl`` (the tanh profile decays below ~2e-8 of its
    interface value there); pass ``cutoff_xi=None`` for the reference's
    exact all-cells evaluation.
    """
    z, y, x = geom.cell_centers()
    gl = np.array(gl_init, dtype=np.float64, copy=True)
    half_inv_xi = 0.5 / params.xi_gl
    R = params.ball_radius

    if cutoff_xi is None:
        X = x[None, None, :]
        Y = y[None, :, None]
        Z = z[:, None, None]
        for c in balls:
            dist = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2
                           + (Z - c[2]) ** 2) + 1e-10
            np.maximum(gl, 0.5 * (1.0 - np.tanh(half_inv_xi * (dist - R))),
                       out=gl)
        return gl

    reach = R + 2.0 * cutoff_xi * params.xi_gl
    for c in balls:
        k0, k1 = np.searchsorted(z, [c[2] - reach, c[2] + reach])
        j0, j1 = np.searchsorted(y, [c[1] - reach, c[1] + reach])
        i0, i1 = np.searchsorted(x, [c[0] - reach, c[0] + reach])
        if k0 >= k1 or j0 >= j1 or i0 >= i1:
            continue
        dist = np.sqrt(
            (x[i0:i1][None, None, :] - c[0]) ** 2
            + (y[j0:j1][None, :, None] - c[1]) ** 2
            + (z[k0:k1][:, None, None] - c[2]) ** 2) + 1e-10
        prof = 0.5 * (1.0 - np.tanh(half_inv_xi * (dist - R)))
        np.maximum(gl[k0:k1, j0:j1, i0:i1], prof,
                   out=gl[k0:k1, j0:j1, i0:i1])
    return gl
