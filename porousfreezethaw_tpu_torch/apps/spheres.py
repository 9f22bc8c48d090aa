"""The spheres DEM settling simulator application (PyTorch).

The counterpart of ``porousfreezethaw_tpu/apps/spheres.py``, the
reference's ``apps/sphere-collider`` family
(``spheres_friction_angular.c:494-626``): spherical particles fall into a
vessel under a soft contact model, and the run writes CSV snapshots.  The
reference selects one of four source variants by symlink and compiles its
constants in; here everything is a CLI flag with the reference defaults.

CLI example::

    python -m porousfreezethaw_tpu_torch.apps.spheres \\
        --variant friction_angular --n 200 --snapshots 400 --output OUTPUT

Snapshot numbering starts from 1 (MATLAB compatibility,
spheres_friction_angular.c:611-613).  The console lines are the JAX
app's.  ``--device cuda`` is the default and raises without a GPU; nothing
falls back to the CPU.

The step control: on the card the solves run the device-resident loop
(``merson_solve_device`` through a ``DEMAttempt``,
``models/dem/attempt.py``; CUDA graphs of attempts, the counterpart of the
JAX app's jitted ``lax.while_loop``), on the dense term and the cell
strategies, in f64 and f32, and on a ``--mesh`` whose shards share the
card (the sharded dense term); ``--device cpu`` and a mesh over several
cards keep the host loop (``merson_solve``), as the JAX app does on the
CPU (``models.dem.dem_solver`` decides by the rule of
``solvers.merson.uses_device_loop``; no option picks the loop).  The two
give the same snapshots byte for byte.  The console's ``Step control:``
line names the loop, and for the host loop why.

``--neighbor cell_list|cell_lanes`` runs the pair term on the cell list
(``models/dem/forces.py``) of ``--cell-capacity`` slots a cell: the solve
then goes in chunks of 512 attempts (the JAX app's chunk on an
accelerator), and the fullest cell is checked after every chunk and every
snapshot; past the capacity the run stops with the JAX app's message (the
``cell_lanes`` pair term also NaN-poisons there).  ``--mesh SPEC`` (e.g.
``p2``; virtual shards of the CPU) shards the particles and runs the
sharded dense pair term, whose results are the single-device ones bit for
bit.

``--device-buffer B`` is the counterpart of the JAX app's scan over B
snapshot targets: B solves, each snapshot's state copied on the device
into a (B, L, n, 3) buffer, the buffer fetched with one copy a batch (a
``fetch``), then the batch's console lines and snapshots, byte for byte
those of B = 0.  The JAX app bounds each interval of a batch by its chunk
of 512 attempts and redoes a batch per snapshot when an interval exceeds
it; here every interval runs ``solve_guarded``'s chunks of 512 attempts
with the occupancy check between them (the cell strategies) or one
unbounded solve (dense), so no interval exceeds a bound and no batch is
redone.  A failed interval (a solver status or a cell overflow) ends the
batch: its earlier snapshots are written, then the run stops as with B =
0.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import torch

from ..core import tracing
from ..core.device import field_dtype, resolve_device
from ..io.csv_snaps import snapshot_path, write_dem_snapshot
from ..io.rklog import format_time
from ..models.dem import (
    CellOverflowError, DEMConfig, dem_solver, icond_2spheres, icond_dense,
    icond_sparse, make_dem_rhs, solve_guarded, write_final_positions)
from ..parallel.sharding import gather_dem_state, make_mesh, shard_dem_state
from ..solvers.merson import MersonParams, host_loop_reason, merson_init

ICONDS = {"dense": icond_dense, "sparse": icond_sparse,
          "2spheres": icond_2spheres}


def fetch(buf: torch.Tensor):
    """A batch's snapshot buffer on the host: its one copy."""
    return buf.cpu().numpy()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="spheres",
        description="DEM sphere settling simulator (PyTorch/CUDA)")
    ap.add_argument("--variant", default="friction_angular",
                    choices=["basic", "basic_WB", "friction",
                             "friction_angular"])
    ap.add_argument("--icond", default="dense", choices=list(ICONDS))
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--r", type=float, default=0.1)
    ap.add_argument("--final-time", type=float, default=8.0)
    ap.add_argument("--snapshots", type=int, default=400)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--ht", type=float, default=0.1)
    ap.add_argument("--ht-min", type=float, default=1e-9)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--output", default="OUTPUT")
    ap.add_argument("--neighbor", choices=["dense", "cell_list",
                                           "cell_roll", "cell_lanes"],
                    default="dense",
                    help="pair search: the exact masked n x n term, or "
                         "the cell list for large n (cell_lanes guards "
                         "its capacity; cell_roll is not ported)")
    ap.add_argument("--cell-capacity", type=int, default=16,
                    help="max particles per cell for the cell "
                         "strategies; occupancy is checked at every "
                         "chunk boundary and overflow aborts loudly "
                         "(cell_lanes also NaN-poisons on overflow)")
    ap.add_argument("--device-buffer", type=int, default=0, metavar="B",
                    help="solve B snapshot intervals, keep their states in "
                         "a device buffer and fetch it with one copy a "
                         "batch (the same snapshots as B = 0)")
    ap.add_argument("--final-positions", default=None, metavar="PATH",
                    help="write resting sphere centers after the run "
                         "(extract_final_positions.m contract; the "
                         "freezing app's ball_positions_file input)")
    ap.add_argument("--precision", choices=["f32", "f64"], default="f64",
                    help="state dtype; the controller scalars are f64 "
                         "always")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, raises without a GPU) or 'cpu'")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="shard particles over a device mesh (e.g. 'p' = "
                         "all devices, 'p4'; virtual shards of the CPU); "
                         "results are mesh-size invariant")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = field_dtype(args.precision)

    cfg = DEMConfig(variant=args.variant, n=args.n, r=args.r,
                    T=args.final_time, ht=args.ht, ht_min=args.ht_min,
                    delta=args.delta, snapshots=args.snapshots)
    if args.icond == "2spheres":
        # the 2-sphere test forces n=2 and zero gravity
        # (spheres_friction_angular.c:398-401)
        cfg = DEMConfig(variant=args.variant, n=2, r=args.r,
                        T=args.final_time, ht=args.ht, ht_min=args.ht_min,
                        delta=args.delta, snapshots=args.snapshots,
                        gravity=(0.0, 0.0, 0.0))
        y0, color = icond_2spheres(cfg)
    else:
        y0, color = ICONDS[args.icond](cfg, seed=args.seed)

    print("Initializing...")
    os.makedirs(args.output, exist_ok=True)
    # the NaN backoff where the JAX app sets it: f32 states
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min,
                          handle_nan=dtype == torch.float32)
    y_dev = {k: torch.as_tensor(v, dtype=dtype, device=device)
             for k, v in y0.items()}
    mesh = None
    if args.mesh:
        mesh = make_mesh(args.mesh, device=device)
        y_dev = shard_dem_state(y_dev, mesh)
        print(f"Particles sharded over mesh {mesh.shape}")
    try:
        rhs = make_dem_rhs(cfg, dtype=dtype, neighbor=args.neighbor,
                           cell_capacity=args.cell_capacity, mesh=mesh,
                           device=device)
    except ValueError as exc:
        ap.error(str(exc))
    state = merson_init(y_dev, 0.0, cfg.ht)
    solver = dem_solver(rhs, device)
    print("Step control: " + (
        f"host loop ({host_loop_reason(device, mesh) or 'by request'})"
        if solver is rhs else "device loop"))

    def one(y):
        return gather_dem_state(y) if mesh is not None else y

    def host_state(y):
        return {k: v.cpu().numpy() for k, v in one(y).items()}

    def t_target(snap):
        return (cfg.T / (cfg.snapshots - 1)) * snap

    def save(snap, y_host, steps, total, elapsed):
        print(f"Done. Elapsed wall time: {format_time(elapsed)}, "
              f"{steps} R-K steps ({total} total)")
        print(f"Saving snapshot {snap + 1} of {cfg.snapshots}.")
        with tracing.span("pft.app.snapshot", snapshot=snap + 1):
            write_dem_snapshot(snapshot_path(args.output, snap + 1), y_host,
                               color, angular=cfg.angular)

    def fail(status, overflow):
        if overflow is not None:
            raise SystemExit(str(overflow))
        print(f"\nsolver failed with status {status}")
        raise SystemExit(1)

    B = args.device_buffer
    buf = None
    if B > 0:
        first = one(state.y)
        keys = list(first)
        buf = torch.empty((B, len(keys)) + tuple(first["pos"].shape),
                          dtype=dtype, device=first["pos"].device)
    start = time.time()
    elapsed = 0.0
    snap = 0
    while snap < cfg.snapshots:
        nb = 1 if buf is None else min(B, cfg.snapshots - snap)
        t0 = time.time()
        done, status, overflow, counts = 0, 0, None, []
        for i in range(nb):
            if buf is None:
                print(f"Solving until t={t_target(snap):f} ....", end="",
                      flush=True)
            try:
                state, status = solve_guarded(solver, state,
                                              t_target(snap + i),
                                              params)[:2]
            except CellOverflowError as exc:
                overflow = exc
            if overflow is not None or status != 0:
                break
            if buf is not None:
                y = one(state.y)
                for j, k in enumerate(keys):
                    buf[i, j].copy_(y[k])
            counts.append((state.steps, state.steps_total))
            done += 1
        elapsed += time.time() - t0
        if buf is None:
            if done:
                save(snap, host_state(state.y), *counts[0], elapsed)
        elif done:
            host = fetch(buf)
            for i in range(done):
                print(f"Solving until t={t_target(snap + i):f} ....",
                      end="")
                save(snap + i, {k: host[i, j] for j, k in enumerate(keys)},
                     *counts[i], elapsed)
        if done < nb:
            if buf is not None:
                print(f"Solving until t={t_target(snap + done):f} ....",
                      end="", flush=True)
            fail(status, overflow)
        snap += nb

    if args.final_positions:
        write_final_positions(args.final_positions, host_state(state.y))
        print(f"Final positions written to: {args.final_positions}")

    print(f"\nSimulation completed in: {format_time(time.time() - start)}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
