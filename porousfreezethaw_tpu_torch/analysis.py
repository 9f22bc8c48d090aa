"""Post-processing / physics observables (PyTorch).

The counterpart of ``porousfreezethaw_tpu/analysis.py``: the reference's
quantitative acceptance metrics (SURVEY §4.5).

* **ice volume fraction** per snapshot: mean of ``p > 0.5`` over the grid
  (``scripts/avg.sh``: ``ncap2 result=(p>0.5)`` then ``ncwa`` average)
* **freezing-point statistic**: mean of ``|(p > 0.5) * u|``
  (``scripts/freezing_point_depression.sh``, ``ncwa -y mabs``)
* **DEM solids volume fraction eps_s**: fraction of a res^3 cell-centered
  sample grid of the unit box covered by spheres of radius r
  (``apps/sphere-collider/OUTPUT/calc_epss.c``)

Each reduction runs with torch on the device it is given (``device``).
When it is None, a tensor argument stays on its own device and any other
input (numpy arrays, snapshot files) goes to the GPU, which raises
:class:`DeviceError` where there is none; pass ``device="cpu"`` for the
host.  The file-series helpers mirror the shell scripts.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.device import resolve_device
from .io.csv_snaps import read_dem_snapshot
from .io.netcdf3 import read_netcdf


def _tensor(x, device, dtype=None) -> torch.Tensor:
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


# ---------------------------------------------------------------------------
# freezing-simulator observables
# ---------------------------------------------------------------------------

def ice_volume_fraction(p, threshold: float = 0.5,
                        device: Optional[torch.device | str] = None) -> float:
    """Mean of (p > threshold) — scripts/avg.sh's FORMULA="p>0.5"."""
    p = _tensor(p, device)
    return float(torch.mean((p > threshold).to(torch.float64)))


def freezing_point_statistic(u, p, threshold: float = 0.5,
                             device: Optional[torch.device | str] = None
                             ) -> float:
    """Mean of |(p > threshold) * u| (ncwa -y mabs of (p>0.5)*u)."""
    u = _tensor(u, device)
    p = _tensor(p, u.device)
    masked = torch.where(p > threshold, u, 0.0)
    return float(torch.mean(torch.abs(masked)))


def snapshot_series(pattern_or_dir: str) -> List[str]:
    """Sorted snapshot files: a directory (``*.ncd``) or a glob pattern."""
    if os.path.isdir(pattern_or_dir):
        pattern = os.path.join(pattern_or_dir, "*.ncd")
    else:
        pattern = pattern_or_dir
    return sorted(_glob.glob(pattern))


def series_statistics(pattern_or_dir: str,
                      device: Optional[torch.device | str] = None
                      ) -> Dict[str, List[float]]:
    """Per-snapshot t, ice volume fraction, and freezing-point statistic
    over a snapshot series — the avg.sh / freezing_point_depression.sh
    pipelines in one pass."""
    out: Dict[str, List[float]] = {"t": [], "ice_fraction": [],
                                   "freezing_point": []}
    for path in snapshot_series(pattern_or_dir):
        data = read_netcdf(path)
        u = data.variables["u"]
        p = data.variables["p"]
        out["t"].append(float(data.attrs.get("t", np.nan)))
        out["ice_fraction"].append(ice_volume_fraction(p, device=device))
        out["freezing_point"].append(
            freezing_point_statistic(u, p, device=device))
    return out


# ---------------------------------------------------------------------------
# DEM solids fraction (calc_epss)
# ---------------------------------------------------------------------------

def eps_s(positions, r: float = 0.1, res: int = 100,
          box_from: Sequence[float] = (0.0, 0.0, 0.0),
          box_to: Sequence[float] = (1.0, 1.0, 1.0),
          device: Optional[torch.device | str] = None) -> float:
    """Solids volume fraction: fraction of res^3 cell-centered sample
    points inside any sphere (calc_epss.c:40-63), in f64.

    One z-plane of the sample grid at a time (res^2 x n distances per
    plane, 16 MB at res = 100, n = 200) instead of the full (res^3 x n)
    tensor, as calc_epss.c streams; a sample point inside several spheres
    counts once per sphere, exactly like the reference's += over all
    spheres."""
    pos = _tensor(positions, device, torch.float64)
    f = torch.tensor(box_from, dtype=torch.float64, device=pos.device)
    t = torch.tensor(box_to, dtype=torch.float64, device=pos.device)
    idx = torch.arange(res, dtype=torch.float64, device=pos.device)
    ax = [f[d] + (t[d] - f[d]) * (0.5 + idx) / res for d in range(3)]
    X = ax[0][None, :, None]
    Y = ax[1][:, None, None]
    # the in-plane part of d2 is the same on every plane
    dxy = (X - pos[:, 0]) ** 2 + (Y - pos[:, 1]) ** 2
    hits = torch.zeros((), dtype=torch.int64, device=pos.device)
    for z in ax[2]:
        d2 = dxy + (z - pos[:, 2]) ** 2
        hits += torch.sum(d2 <= r * r)
    return int(hits) / res**3


def eps_s_series(output_dir: str, r: float = 0.1, res: int = 100,
                 snapshots: int = 400, stride: int = 2,
                 base: str = "snap",
                 device: Optional[torch.device | str] = None) -> List[float]:
    """eps_s over a snapshot series (calc_epss.c's snap_stride loop)."""
    out = []
    for snap in range(stride, snapshots + 1, stride):
        path = os.path.join(output_dir, f"{base}_{snap:03d}.csv")
        cols = read_dem_snapshot(path)
        pos = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        out.append(eps_s(pos, r=r, res=res, device=device))
    return out
