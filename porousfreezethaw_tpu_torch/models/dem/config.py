"""DEM simulation configuration.

The reference compiles all parameters into the binary and selects one of
four source variants via a symlink (``apps/sphere-collider/Select.sh``,
``spheres_friction_angular.c:26-78``); here the variant and every constant
are runtime configuration with the reference's values as defaults.

Variants (each adds to the previous):
* ``basic``            — exponential repulsion + velocity-dependent rebound
                         (spheres_basic.c:202-286)
* ``basic_WB``         — linear Walton–Braun spring contact, k = 5e3
                         (spheres_basic_WB.c:52,207-209)
* ``friction``         — + tangential Coulomb-like friction with S-shape
                         low-velocity limiter (spheres_friction.c:212-305)
* ``friction_angular`` — + sphere rotation: 9n state, surface velocity
                         from omega x r, torque with solid-ball inertia
                         I = (2/5) r^2 (spheres_friction_angular.c:109,298-355)

A numpy-only copy of ``porousfreezethaw_tpu/models/dem/config.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

VARIANTS = ("basic", "basic_WB", "friction", "friction_angular")


@dataclasses.dataclass(frozen=True)
class Wall:
    """A planar wall: reference point P and (unnormalized) normal n
    (spheres_friction_angular.c:84-98)."""
    P: Tuple[float, float, float]
    n: Tuple[float, float, float]


# bottom, left, right, front, rear (spheres_friction_angular.c:89-96)
DEFAULT_WALLS: Tuple[Wall, ...] = (
    Wall((0, 0, 0), (0, 0, -1)),
    Wall((0, 0, 0), (-1, 0, 0)),
    Wall((1, 0, 0), (1, 0, 0)),
    Wall((0, 0, 0), (0, -1, 0)),
    Wall((0, 1, 0), (0, 1, 0)),
)


@dataclasses.dataclass(frozen=True)
class DEMConfig:
    variant: str = "friction_angular"
    n: int = 200                  # number of spheres
    r: float = 0.1                # sphere radius
    R: float = 1.0                # vessel base dimension
    T: float = 8.0                # final time
    COR: float = 0.4              # coefficient of restitution
    dissipation_focusing: float = 10.0
    friction: float = 0.2
    p_eps1: float = 0.01          # friction low-velocity limiter threshold
    collision_force_multiplier: float = 10.0
    collision_force_exponent: float = 150.0
    WB_stiffness: float = 5e3     # basic_WB only
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    ht: float = 0.1               # initial time step
    ht_min: float = 1e-9
    delta: float = 0.1
    snapshots: int = 400
    zero: float = 1e-8            # distance/velocity regularization
    walls: Tuple[Wall, ...] = DEFAULT_WALLS

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown DEM variant {self.variant!r}")

    @property
    def h0(self) -> float:
        """Initial height of the lowest sphere (1.0 + r)."""
        return 1.0 + self.r

    @property
    def max_surf_dist(self) -> float:
        """Interaction cutoff — equal to r in every reference variant."""
        return self.r

    @property
    def inertia(self) -> float:
        """Moment of inertia of a unit-mass solid ball, (2/5) r^2."""
        return 0.4 * self.r * self.r

    @property
    def angular(self) -> bool:
        return self.variant == "friction_angular"

    @property
    def has_friction(self) -> bool:
        return self.variant in ("friction", "friction_angular")

    def wall_arrays(self, dtype=np.float64):
        """(P, n_normalized) arrays of shape (num_walls, 3); normals are
        normalized at startup like spheres_friction_angular.c:543-550."""
        P = np.array([w.P for w in self.walls], dtype=dtype)
        n = np.array([w.n for w in self.walls], dtype=dtype)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        return P, n
