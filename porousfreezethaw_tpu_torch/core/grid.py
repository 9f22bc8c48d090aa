"""Grid geometry for the finite-volume freezing simulator.

The reference uses a cell-centered FVM grid of ``n1 x n2 x total_n3`` inner
cells with a ghost layer of thickness 2 on all sides and a flat array layout
``VAR(w,q) = w + q*subgridSIZE`` (``intertrack.c:425-431, 1776-1789``).

Here the simulation *state* holds only the inner cells, shaped
``(VAR_COUNT, n3, n2, n1)`` (z-major, matching the reference's memory
order), and boundary/halo values are produced functionally inside the RHS.
The 7-point stencil needs a single ghost cell; the reference's thickness-2
layer only raises the order of the *mirror* BC representation, not of the
stencil itself (``equation.c:38,187-199``).

Axis convention for arrays: axis 0 = z (k, length n3), axis 1 = y (j, n2),
axis 2 = x (i, n1).  Cell centers: x = L1*(0.5+i)/n1 etc.
(``intertrack.c:1831-2020``, ``equation.c:509-516``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Domain dimensions and inner-cell counts."""

    L1: float  # x extent [m]
    L2: float  # y extent [m]
    L3: float  # z extent [m]
    n1: int    # cells along x
    n2: int    # cells along y
    n3: int    # cells along z (the reference's total_n3)

    @property
    def shape(self) -> tuple[int, int, int]:
        """(z, y, x) array shape of one field."""
        return (self.n3, self.n2, self.n1)

    @property
    def num_cells(self) -> int:
        return self.n1 * self.n2 * self.n3

    # 1/h factors used by the difference quotients (equation.c:604-612)
    @property
    def inv_h(self) -> tuple[float, float, float]:
        """(1/h1, 1/h2, 1/h3) = (n1/L1, n2/L2, n3/L3)."""
        return (self.n1 / self.L1, self.n2 / self.L2, self.n3 / self.L3)

    def cell_centers(self, dtype=np.float64):
        """1-D coordinate arrays (z, y, x) of the cell centers."""
        k = np.arange(self.n3, dtype=dtype)
        j = np.arange(self.n2, dtype=dtype)
        i = np.arange(self.n1, dtype=dtype)
        z = self.L3 * (0.5 + k) / self.n3
        y = self.L2 * (0.5 + j) / self.n2
        x = self.L1 * (0.5 + i) / self.n1
        return z, y, x

    def relative_centers(self, dtype=np.float64):
        """1-D relative coordinates (_z, _y, _x) spanning (0, 1)."""
        z, y, x = self.cell_centers(dtype)
        return z / self.L3, y / self.L2, x / self.L1

    @staticmethod
    def from_grid_nodes(L1: float, L2: float, L3: float, grid_nodes: int) -> "GridGeometry":
        """Reference Params convention: 'grid_nodes' cells along the longest
        side; the others scale with their lengths (Params:136-144)."""
        multiplier = grid_nodes / max(L1, L2, L3)
        return GridGeometry(
            L1, L2, L3,
            n1=int(L1 * multiplier), n2=int(L2 * multiplier), n3=int(L3 * multiplier),
        )
