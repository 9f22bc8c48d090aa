"""The initial-condition formulas of ``intertrack-mr-gradp.params.txt``
(its ``icond`` lines), for the plain reference: numpy on broadcast cell
centres x, y, z [m] and the configuration's constants ``prm``."""

import numpy as np


def icond(x, y, z, prm):
    L1, L2 = prm["L1"], prm["L2"]
    xi_gl = prm["xi_gl"]
    ox, oy, oz = (prm["beads_offset_x"], prm["beads_offset_y"],
                  prm["beads_offset_z"])
    u = np.full(np.broadcast(x, y, z).shape, 293.15)
    p = ((z > 0.052) & (z < 0.058)
         & ((x - L1 / 2) ** 2 + (y - L2 / 2) ** 2 < (L1 / 3) ** 2)) * 1.0

    def wall(s):
        return 0.5 * (1.0 + np.tanh(0.5 / xi_gl * s))

    gl = np.maximum.reduce(np.broadcast_arrays(
        wall(z - 0.055), wall(oz - z), wall(x - L1 + ox), wall(y - L2 + oy),
        wall(ox - x), wall(oy - y)))
    return u, p, gl
