"""Snapshot / checkpoint datasets for the freezing simulator.

Reproduces the reference's NetCDF snapshot contract
(``intertrack.c:2297-2455``):

* filename ``{out_file}.{snapshot:03d}{suffix}``; on-demand snapshots
  ``{out_file}.{snapshot:03d}.{on_demand:03d}{suffix}``
* dimensions ``n3, n2, n1`` with double coordinate variables of the same
  names holding the cell-center coordinates
* double field variables ``u, p, gl`` with dims (n3, n2, n1)
* global attributes: L1..L3, every model parameter by name, ``calc_mode``
  (int), ``delta``, ``tau`` (the *current* continuation step), ``t``,
  ``final_time``, ``snapshot``, ``total_snapshots`` (ints), and ``title``
  built as "Intertrack simulation (<comment>). Time: <t>"
  (``intertrack.c:1129, 2370-2406``)

Every snapshot is a complete checkpoint: ``load_checkpoint`` restores the
state for `continue_series` resume (``intertrack.c:1642-1669``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.grid import GridGeometry
from ..models.freezing.parameters import FreezingParams, PARAM_NAMES, VARIABLES
from .netcdf3 import (NC_DOUBLE, create_netcdf, read_netcdf, write_block,
                      write_netcdf)


def snapshot_filename(out_file: str, snapshot: int, suffix: str,
                      on_demand: Optional[int] = None) -> str:
    if on_demand is not None:
        return f"{out_file}.{snapshot:03d}.{on_demand:03d}{suffix}"
    return f"{out_file}.{snapshot:03d}{suffix}"


BCOND_THICKNESS = 2  # equation.c:38


def write_snapshot(
    path: str,
    geom: GridGeometry,
    params: FreezingParams,
    state_fields: np.ndarray,       # (3, n3, n2, n1)
    *,
    calc_mode: int,
    delta: float,
    tau: float,
    t: float,
    final_time: float,
    snapshot: int,
    total_snapshots: int,
    comment: str = "",
    grid_mode: str = "inner",
) -> None:
    """``grid_mode='full'`` reproduces the reference's troubleshooting
    output including the bcond_thickness=2 ghost layer (grid_IO_mode==0,
    intertrack.c:2338-2340,2436-2446): mirror ghosts everywhere, both
    temperature ghost planes at the z-top set to the Dirichlet value."""
    fields = np.asarray(state_fields, dtype=np.float64)
    b = BCOND_THICKNESS if grid_mode == "full" else 0
    if grid_mode == "full":
        # FVM mirror: first phantom = adjacent interior (np 'symmetric')
        fields = np.pad(fields, ((0, 0),) + ((b, b),) * 3, mode="symmetric")
        d_val = (params.top_temp1 if t < params.phase_switch_time
                 else params.top_temp2)
        fields[0, -b:, :, :] = d_val

    k = np.arange(fields.shape[1], dtype=np.float64)
    j = np.arange(fields.shape[2], dtype=np.float64)
    i = np.arange(fields.shape[3], dtype=np.float64)
    z = geom.L3 * (0.5 + k - b) / geom.n3
    y = geom.L2 * (0.5 + j - b) / geom.n2
    x = geom.L1 * (0.5 + i - b) / geom.n1

    dims = {"n3": fields.shape[1], "n2": fields.shape[2],
            "n1": fields.shape[3]}
    variables = [
        ("n3", ("n3",), z), ("n2", ("n2",), y), ("n1", ("n1",), x),
    ]
    for q, name in enumerate(VARIABLES):
        variables.append((name, ("n3", "n2", "n1"), fields[q]))

    attrs = _snapshot_attrs(
        geom, params, calc_mode=calc_mode, delta=delta, tau=tau, t=t,
        final_time=final_time, snapshot=snapshot,
        total_snapshots=total_snapshots, comment=comment)

    write_netcdf(path, dims, variables, attrs)


def _snapshot_attrs(geom, params, *, calc_mode, delta, tau, t, final_time,
                    snapshot, total_snapshots, comment):
    attrs: Dict[str, object] = {"L1": geom.L1, "L2": geom.L2, "L3": geom.L3}
    pdict = params.as_dict()
    for name in PARAM_NAMES:
        attrs[name] = float(pdict[name])
    attrs["calc_mode"] = int(calc_mode)
    attrs["delta"] = float(delta)
    attrs["tau"] = float(tau)
    attrs["t"] = float(t)
    attrs["final_time"] = float(final_time)
    attrs["snapshot"] = int(snapshot)
    attrs["total_snapshots"] = int(total_snapshots)
    attrs["title"] = f"Intertrack simulation ({comment}). Time: {t:g}"
    return attrs


def write_snapshot_sharded(
    path: str,
    geom: GridGeometry,
    params: FreezingParams,
    shards,                         # per-shard (3, zl, Yl, n1) tensors
    mesh,                           # parallel.sharding.Mesh
    *,
    calc_mode: int,
    delta: float,
    tau: float,
    t: float,
    final_time: float,
    snapshot: int,
    total_snapshots: int,
    comment: str = "",
    u_shift: float = 0.0,
) -> None:
    """Gather-free snapshot write (inner grid): the contract of
    :func:`write_snapshot`, but each shard's (zl, Yl, n1) block is written
    into its hyperslab of the file at (z0, y0, 0), the counterpart of the
    JAX package's ``write_snapshot_sharded`` and of the reference's
    gather-to-master + nc_put_vara loop (``intertrack.c:2459-2546``).
    ``u_shift`` is added to the temperature per shard in the state's own
    dtype, as the gathered path's unshift does, so the file is byte for
    byte the gathered one.  Replicated shards (mesh axes other than z and
    y) write the same block."""
    from ..parallel.sharding import shard_block

    n3, n2, n1 = geom.shape
    dims = {"n3": n3, "n2": n2, "n1": n1}
    var_specs = [("n3", ("n3",), NC_DOUBLE), ("n2", ("n2",), NC_DOUBLE),
                 ("n1", ("n1",), NC_DOUBLE)]
    var_specs += [(name, ("n3", "n2", "n1"), NC_DOUBLE) for name in VARIABLES]
    attrs = _snapshot_attrs(
        geom, params, calc_mode=calc_mode, delta=delta, tau=tau, t=t,
        final_time=final_time, snapshot=snapshot,
        total_snapshots=total_snapshots, comment=comment)
    layouts = create_netcdf(path, dims, var_specs, attrs)
    z, y, x = geom.cell_centers()
    write_block(path, layouts["n3"], z, (0,))
    write_block(path, layouts["n2"], y, (0,))
    write_block(path, layouts["n1"], x, (0,))
    for i, shard in enumerate(shards):
        block = np.array(shard[:len(VARIABLES)].cpu().numpy(), copy=True)
        if u_shift:
            block[0] += block.dtype.type(u_shift)
        zs, ys = shard_block(mesh, i, geom.shape)
        for q, name in enumerate(VARIABLES):
            write_block(path, layouts[name], block[q].astype(np.float64),
                        (zs.start, ys.start, 0))


@dataclasses.dataclass
class Checkpoint:
    fields: np.ndarray              # (3, n3, n2, n1)
    geom_dims: Tuple[int, int, int]  # (n1, n2, n3)
    t: float
    tau: float
    snapshot: int
    total_snapshots: int
    final_time: float
    attrs: Dict[str, object]


def load_checkpoint(path: str) -> Checkpoint:
    """Read a snapshot for icond loading / continue_series resume
    (intertrack.c:1598-1689, 2023-2117)."""
    data = read_netcdf(path)
    missing = [v for v in VARIABLES if v not in data.variables]
    if missing:
        raise ValueError(f"{path}: dataset lacks variables {missing}")
    fields = np.stack([np.asarray(data.variables[v], dtype=np.float64)
                       for v in VARIABLES])
    a = data.attrs
    return Checkpoint(
        fields=fields,
        geom_dims=(data.dims["n1"], data.dims["n2"], data.dims["n3"]),
        t=float(a.get("t", 0.0)),
        tau=float(a.get("tau", 1.0)),
        snapshot=int(a.get("snapshot", 0)),
        total_snapshots=int(a.get("total_snapshots", 0)),
        final_time=float(a.get("final_time", 0.0)),
        attrs=dict(a),
    )
