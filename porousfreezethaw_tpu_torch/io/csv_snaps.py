"""DEM CSV snapshot writer (save_snapshot, spheres_*.c).

A numpy-only copy of ``porousfreezethaw_tpu/io/csv_snaps.py``: the same
bytes, through the same native encoder or the same Python fallback.

Formats per variant:
* basic / basic_WB / friction: header ``x,y,z,color``
  (spheres_basic.c:298-301, spheres_friction.c:317-320)
* friction_angular: header ``x,y,z,vx,vy,vz,avx,avy,avz,color``
  (spheres_friction_angular.c:375-378)

Values use C "%f" formatting (6 decimal places).  Snapshot numbering
starts from 1 for MATLAB compatibility (spheres_friction_angular.c:611-613);
filename pattern ``OUTPUT/snap_%03d.csv``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def snapshot_path(output_dir: str, snap: int, base: str = "snap") -> str:
    return os.path.join(output_dir, f"{base}_{snap:03d}.csv")


def write_dem_snapshot(path: str, state: Dict[str, np.ndarray],
                       color: np.ndarray, angular: bool) -> None:
    pos = np.asarray(state["pos"])
    if angular:
        header = "x,y,z,vx,vy,vz,avx,avy,avz,color"
        rows = np.concatenate(
            [pos, np.asarray(state["vel"]), np.asarray(state["angvel"]),
             np.asarray(color)[:, None]], axis=1)
    else:
        header = "x,y,z,color"
        rows = np.concatenate([pos, np.asarray(color)[:, None]], axis=1)

    # fast path: the native C++ encoder (native/dataio.cc)
    from .. import native
    if native.write_dem_csv_rows(path, header, rows):
        return
    with open(path, "w") as f:
        f.write(header + "\n")
        for row in rows:
            f.write(",".join("%f" % v for v in row) + "\n")


def read_dem_snapshot(path: str) -> Dict[str, np.ndarray]:
    """Read a snapshot CSV back into column arrays (for tests/eps_s)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        data = np.loadtxt(f, delimiter=",", ndmin=2)
    return {name: data[:, i] for i, name in enumerate(header)}
