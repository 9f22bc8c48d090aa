"""The intertrack freezing/thawing simulator application (PyTorch).

The counterpart of ``porousfreezethaw_tpu/apps/intertrack.py`` and a
drop-in equivalent of the reference application
(``apps/intertrack-hybrid-S-freezing/intertrack.c``): it reads the same
Params files, produces the same NetCDF snapshot series with the same
filenames, attribute contract and log structure, and supports formula and
dataset initial conditions, ``continue_series`` resume, batch sweeps with
mnemonics and ``continue_if``, the RK debug log, on-demand snapshots via a
trigger file, and post-processing script execution.

CLI:  ``python -m porousfreezethaw_tpu_torch.apps.intertrack param_file
[master_rank] [ubound_list] [--precision f32|f64] [--device cuda|cpu]
[--mesh SPEC]`` (``intertrack.c:1304``; master_rank is accepted for
command-line compatibility and ignored).

Solver paths: f64 integrates the plain PyTorch right-hand side; f32 without
a noise field runs the increment-form attempt through the CUDA kernels
(``increment_form 1``, the default; with ``compensated_commit 1`` its
double-f32 commit variant) or the classic fused stage kernel
(``increment_form 0``).  On ``--device cpu`` the kernel wrappers compute
with their plain PyTorch versions.

``--mesh`` (``'z'``, ``'z4'``, ``'z2,y2'``, over the visible devices of
``--device``) shards the f32 solve: a z mesh runs ``ShardedDeltaAttempt``
(or, under ``increment_form 0``, the sharded classic stage), a z,y mesh
``ShardedDeltaAttempt2D``, which ignores ``compensated_commit`` as the JAX
app does.  Snapshots are then written shard by shard.  The JAX app's other
mesh branch (f64, a noise field, or a mesh the grid does not divide) is
not ported yet and raises.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config.params import (
    ParamError, ParamFile, batch_iterations, loop_suffix, parse_param_file)
from ..core.device import field_dtype, numpy_dtype, resolve_device
from ..core.grid import GridGeometry
from ..io.rklog import RKDebugLog, RunLog, format_date, format_time
from ..io.snapshots import (
    load_checkpoint, write_snapshot, write_snapshot_sharded)
from ..models.freezing.equation import make_noise_field, make_rhs
from ..models.freezing.glass import build_glass_field, read_ball_positions
from ..models.freezing.icond import build_initial_conditions
from ..models.freezing.parameters import (
    PARAM_INFO, FreezingParams, shift_temperature_origin)
from ..ops.cuda.stencil import DeltaAttempt, DeltaAttemptComp, make_fused_stage
from ..parallel.fused import (
    ShardedDeltaAttempt, ShardedDeltaAttempt2D, make_sharded_fused_stage)
from ..parallel.sharding import (
    gather_freezing_state, make_mesh, shard_freezing_state)
from ..solvers.merson import (
    INTERRUPTED, MersonParams, merson_init, merson_solve)

DEFAULT_BALL_POSITIONS = "data/spheres_positions.txt"  # equation.c:35


class IntertrackError(RuntimeError):
    pass


def _unshift(fields: np.ndarray, u_shift: float) -> np.ndarray:
    """Restore absolute temperatures before writing a snapshot."""
    if not u_shift:
        return fields
    out = np.array(fields, copy=True)
    out[0] += u_shift
    return out


def _require(pf: ParamFile, name: str) -> float:
    try:
        return pf.get(name)
    except ParamError:
        raise IntertrackError(
            f"Variable check error: {name} is not defined (see the log)")


def run_iteration(
    pf: ParamFile,
    log: RunLog,
    *,
    device: torch.device,
    dtype: torch.dtype = torch.float64,
    loop_iter: int = 0,
    loop_values: Optional[List[int]] = None,
    loop_ubounds: Optional[List[int]] = None,
    debug_log: Optional[RKDebugLog] = None,
    mesh_axes: Optional[str] = None,
    mesh_devices: Optional[Sequence] = None,
) -> Dict[str, float]:
    """One full simulation (one batch iteration).  Returns run stats.

    ``mesh_axes`` shards the solve over ``make_mesh(mesh_axes,
    mesh_devices)``; ``mesh_devices`` defaults to the visible devices of
    ``device`` and may repeat a device."""
    np_dtype = numpy_dtype(dtype)

    # ---------- parameters setting (intertrack.c:1489-1577) ----------
    log("\nSetting geometry parameters:\n")
    L1 = _require(pf, "L1")
    log("Domain base width: %g\n", L1)
    L2 = _require(pf, "L2")
    log("Domain base height: %g\n", L2)
    L3 = _require(pf, "L3")
    log("Domain depth: %g\n", L3)

    log("\nSetting model parameters:\n")
    values: Dict[str, float] = {}
    for name, desc in PARAM_INFO:
        if name is None:
            log("\n--- %s ---\n\n", desc)
            continue
        values[name] = _require(pf, name)
        log("%-70s : %-23s = %g\n", desc, name, values[name])
    params = FreezingParams.from_dict(values)

    log("\nSetting numerical solution parameters:\n")
    calc_mode = pf.get_int("calc_mode", 0)
    log("Calculation mode: %d\n", calc_mode)
    n1 = pf.get_int("n1", 0)
    n2 = pf.get_int("n2", 0)
    total_n3 = pf.get_int("n3", 0)
    log("Grid X inner nodes: %d\nGrid Y inner nodes: %d\nGrid Z inner nodes: %d\n",
        n1, n2, total_n3)

    total_snapshots = pf.get_int("saved_files")
    log("Number of snapshots (the zeroth snapshot is the init. cond.): %d\n",
        total_snapshots)
    tau = pf.get("tau")
    log("Initial time step: %g\n", tau)
    final_time = pf.get("final_time")
    log("Final time : %g\n", final_time)
    delta = pf.get("delta")
    log("Runge-Kutta-Merson solver tolerance (delta) : %g\n", delta)
    tau_min = pf.get("tau_min", 0.0)
    log("Time step lower bound for RKM iteration to be controlled by delta : %g\n",
        tau_min)
    comment = pf.setting("comment")
    log("Comment: %s\n", comment)

    icond_file = pf.setting("icond_file")
    continue_series = pf.flag("continue_series")
    starting_time = 0.0
    starting_snapshot = 0

    # ---------- initial conditions ----------
    if icond_file:
        log("\nChecking availability of the initial conditions input dataset ...\n")
        ck = load_checkpoint(icond_file)
        ck_n1, ck_n2, ck_n3 = ck.geom_dims
        for label, have, stored in (("n1", n1, ck_n1), ("n2", n2, ck_n2),
                                    ("n3", total_n3, ck_n3)):
            if have == 0:
                log("%s=%d(STORED) ", label, stored)
            elif have != stored:
                raise IntertrackError(
                    f"{label} has been previously defined as {have}, dataset "
                    f"has {stored}")
            else:
                log("%s=%d(OK) ", label, have)
        log("\n")
        n1, n2, total_n3 = ck_n1, ck_n2, ck_n3
        geom = GridGeometry(L1, L2, L3, n1, n2, total_n3)
        w0 = ck.fields
        if continue_series:
            starting_snapshot = ck.snapshot
            total_snapshots = ck.total_snapshots
            starting_time = ck.t
            final_time = ck.final_time
            tau = ck.tau
            log("\nSeries continuation mode has been requested.\n"
                "Starting snapshot: %d\nStarting time: %g\n"
                "Initial time step override: %g\nFinal time override: %g\n"
                "Total number of snapshots override: %d\n",
                starting_snapshot, starting_time, tau, final_time,
                total_snapshots)
    else:
        if continue_series:
            log("Warning: continue_series is only meaningful when the "
                "initial conditions are loaded from file.\n")
        if n1 < 1 or n2 < 1 or total_n3 < 1:
            raise IntertrackError("The grid dimensions must be at least 1")
        geom = GridGeometry(L1, L2, L3, n1, n2, total_n3)
        loop_env = {f"i{q+1}": v for q, v in enumerate(loop_values or [])}
        w0 = build_initial_conditions(geom, params, pf.icond_formulas,
                                      loop_vars=loop_env, dtype=np_dtype)

    # ---------- PrecalculateData: noise + glass balls (equation.c:439-558) ----
    noise = make_noise_field(geom, params, loop_iter, dtype=np_dtype)

    ball_file = pf.setting("ball_positions_file", DEFAULT_BALL_POSITIONS)
    try:
        balls = read_ball_positions(ball_file, params)
        log("Successfully read coordinates of %d glass balls.\n\n", len(balls))
    except OSError:
        log("ERROR: Could not read glass balls coordinates from: %s\n", ball_file)
        raise IntertrackError("Reading glass balls positions failed.")
    w0 = np.asarray(w0, dtype=np_dtype)
    w0[2] = build_glass_field(geom, params, balls, w0[2])

    models = ["Phase field / GradP", "Phase field / SigmaP1-P",
              "Heat equation with latent heat release focusing"]
    if calc_mode not in (0, 1, 2, 10, 11):
        raise IntertrackError(f"invalid calc_mode value {calc_mode}")
    log("\nSolidification model: %s\n\n", models[calc_mode % 10])

    # ---------- solver setup ----------
    f32 = dtype == torch.float32
    # f32 runs store u - u_star: exact reformulation that drops the error
    # estimator's f32 rounding floor ~16x (see shift_temperature_origin)
    u_shift = params.u_star if f32 else 0.0
    solver_params = (shift_temperature_origin(params, u_shift)
                     if u_shift else params)
    if u_shift:
        w0[0] -= u_shift
        log("Temperature origin shifted by u_star for f32 conditioning.\n")

    rhs = make_rhs(geom, solver_params, calc_mode, device, noise=noise)
    y0 = torch.as_tensor(np.ascontiguousarray(w0)).to(device)
    stage_fn = None
    attempt_fn = None
    # The increment-form (delta) attempt is the f32 default for all
    # models: its exact f(w+d)-f(w) stages remove the f32 stage-state
    # rounding floor from the error estimator (models/freezing/delta.py),
    # so the controller keeps the exact reference step-control rule.  The
    # classic stage kernel stays selectable (`increment_form 0`), with the
    # noise-floor escape below.
    use_delta = bool(pf.vars.get("increment_form", 1.0))
    # compensated (double-f32) commit, off by default: the JAX package's
    # round-5 A/B found it does not reduce the f32 step inflation
    use_comp = bool(pf.vars.get("compensated_commit", 0.0))
    mesh = None
    if mesh_axes:
        mesh = make_mesh(mesh_axes, mesh_devices, device=device)
        log("Device mesh: %s\n", mesh.shape)
        nz, ny = mesh.shape.get("z", 1), mesh.shape.get("y", 1)
        axes = set(mesh.axis_names)
        fits = (total_n3 % nz == 0 and total_n3 // nz >= 2
                and n2 % ny == 0)
        if not (f32 and noise is None and fits
                and (axes == {"z"} or (axes == {"z", "y"} and use_delta))):
            # the JAX app's GSPMD fallback over the plain right-hand side
            raise NotImplementedError(
                "--mesh: this mesh path (f64, a noise field, a mesh the grid "
                "does not divide, or the classic stage on a z,y mesh) is not "
                "ported yet")
        if axes == {"z"} and use_delta:
            attempt_fn = ShardedDeltaAttempt(geom, solver_params, calc_mode,
                                             mesh, compensated=use_comp)
            log("Increment-form (delta) attempt kernels: ON%s (sharded over "
                "z=%d)\n", " (compensated commit)" if use_comp else "", nz)
        elif axes == {"z"}:
            stage_fn = make_sharded_fused_stage(geom, solver_params,
                                                calc_mode, mesh)
            log("Fused stage kernel: ON (sharded over z=%d)\n", nz)
        else:
            attempt_fn = ShardedDeltaAttempt2D(geom, solver_params,
                                               calc_mode, mesh)
            log("Increment-form (delta) attempt kernels: ON (sharded over "
                "z=%d, y=%d)\n", nz, ny)
        y0 = shard_freezing_state(y0, mesh)
    elif f32 and noise is None:
        if use_delta:
            cls = DeltaAttemptComp if use_comp else DeltaAttempt
            attempt_fn = cls(geom, solver_params, calc_mode)
            log("Increment-form (delta) attempt kernels: ON%s (%s)\n",
                " (compensated commit)" if use_comp else "", device.type)
        else:
            stage_fn = make_fused_stage(geom, solver_params, calc_mode)
            log("Fused stage kernel: ON (%s)\n", device.type)

    state = merson_init(y0, starting_time, tau)
    # the classic f32 stage path enables the noise-floor escape (the f32
    # stage-state rounding puts an h-independent floor under the Merson
    # error estimate); f64 and the increment form keep the exact
    # reference rule.  Overridable as a Params variable.
    default_growth = 1.05 if f32 and attempt_fn is None else 0.0
    growth_min = float(pf.vars.get("accept_growth_min", default_growth))
    # NaN/Inf backoff (the solver's opt-in recovery, RK_Asolver.c:96-131):
    # in f32 the GradP stage cascade overflows at tau=1 and h would spin at
    # 0 forever; the backoff shrinks h tenfold per attempt until finite.
    handle_nan = bool(pf.vars.get("handle_nan", f32))
    mparams = MersonParams(delta=delta, h_min=tau_min,
                           accept_growth_min=growth_min,
                           handle_nan=handle_nan)
    if growth_min:
        log("f32 step-control: accept-side minimum h growth %.2f\n",
            growth_min)

    # service facility: RK debug log + snapshot trigger (intertrack.c:1072-1116)
    trigger_file = pf.setting("snapshot_trigger")
    service = None
    if debug_log is not None or trigger_file:
        def service(t, h, steps):
            if debug_log is not None:
                debug_log.log_step(t, h, steps)
            if trigger_file and os.path.exists(trigger_file):
                return 1
            return 0

    def solve(st, ft):
        return merson_solve(rhs, st, ft, mparams, service_callback=service,
                            stage_fn=stage_fn, attempt_fn=attempt_fn)

    # ---------- output naming (incl. batch dirs, intertrack.c:1437-1484) ----
    out_file = pf.setting("out_file")
    if not out_file:
        raise IntertrackError("Output file not specified.")
    suffix = pf.setting("out_file_suffix")
    if loop_ubounds:
        sfx = loop_suffix(loop_values, loop_ubounds, pf.mnemonics)
        out_dir = out_file + sfx
        os.makedirs(out_dir, exist_ok=True)
        base_name = os.path.basename(out_file)

        def fname(snap, on_demand=None):
            mid = f".{snap:03d}" + ("" if on_demand is None else f".{on_demand:03d}")
            return f"{out_dir}/{base_name}{mid}{sfx}{suffix}"
    else:
        def fname(snap, on_demand=None):
            mid = f".{snap:03d}" + ("" if on_demand is None else f".{on_demand:03d}")
            return f"{out_file}{mid}{suffix}"

    skip_icond = pf.flag("skip_icond")

    # ---------- snapshot loop (intertrack.c:2265-2560) ----------
    log("\nStarting the simulation on: %s\n\n", format_date())
    wall_start = time.time()
    elapsed_solver = 0.0
    on_demand_counter = 0
    snapshot = starting_snapshot
    while snapshot < total_snapshots:
        log("Calculating snapshot %d ... ", snapshot)
        is_on_demand = False
        t0 = time.time()
        if snapshot > starting_snapshot:
            next_snapt = starting_time + (
                (final_time - starting_time) * (snapshot - starting_snapshot)
                / (total_snapshots - 1 - starting_snapshot))
            if debug_log is not None:
                debug_log.set_snapshot(snapshot, next_snapt)
            state, status = solve(state, next_snapt)
            if status == INTERRUPTED:
                is_on_demand = True
            elif status != 0:
                raise IntertrackError(f"solver failed with status {status}")
        elapsed_solver += time.time() - t0

        if is_on_demand:
            log("On-demand snapshot triggered on %s - elapsed wall time: %s, "
                "%d R-K steps, t=%g\n", format_date(),
                format_time(elapsed_solver), state.steps, state.t)
            filename = fname(snapshot - 1, on_demand_counter)
            on_demand_counter += 1
        else:
            log("Done on %s - elapsed wall time: %s, %d R-K steps (%d total)\n",
                format_date(), format_time(elapsed_solver), state.steps,
                state.steps_total)
            filename = fname(snapshot)
        log("Saving file: %s ... [", filename)

        if snapshot == starting_snapshot and skip_icond and not is_on_demand:
            log("SKIPPED]\n")
            snapshot += 1
            continue
        if not is_on_demand:
            on_demand_counter = 0

        snap_kw = dict(
            calc_mode=calc_mode, delta=delta, tau=state.h, t=state.t,
            final_time=final_time,
            snapshot=snapshot - 1 if is_on_demand else snapshot,
            total_snapshots=total_snapshots, comment=comment)
        if mesh is not None and pf.grid_io_mode == "inner":
            # gather-free: each shard writes its own block
            write_snapshot_sharded(filename, geom, params, state.y, mesh,
                                   u_shift=u_shift, **snap_kw)
        else:
            y_out = (gather_freezing_state(state.y, mesh)
                     if mesh is not None else state.y)
            # [:3] strips the compensated commit's lo planes when present
            write_snapshot(filename, geom, params,
                           _unshift(y_out[:3].cpu().numpy(), u_shift),
                           grid_mode=pf.grid_io_mode, **snap_kw)
        log("OK]\n")
        log.commit()

        if is_on_demand:
            # trigger file is deleted after the snapshot (intertrack.c:330-334)
            try:
                os.remove(trigger_file)
            except OSError:
                pass
        else:
            snapshot += 1

    wall = time.time() - wall_start
    log("\nThe simulation has been completed successfully.\n"
        "Successful R-K steps: %d of %d total\n"
        "Solver wall time: %s\nOverall wall time: %s\n",
        state.steps, state.steps_total,
        format_time(elapsed_solver), format_time(wall))

    return {
        "steps": state.steps, "steps_total": state.steps_total,
        "wall": wall, "solver_wall": elapsed_solver, "t": state.t,
    }


def run_pproc(pf: ParamFile, log: RunLog, out_dir_arg: str,
              children: List[subprocess.Popen]) -> None:
    """Post-processing script execution (intertrack.c:2572-2640)."""
    script = pf.setting("pproc_script")
    if not script:
        return
    log("Executing the postprocessing script: %s %s\n", script, out_dir_arg)
    if pf.flag("pproc_nowait"):
        children.append(subprocess.Popen(
            [script, out_dir_arg],
            preexec_fn=lambda: os.nice(10)))
        if pf.flag("pproc_waitfirst") and len(children) == 1:
            code = children[0].wait()
            _check_pproc(pf, log, code)
    else:
        code = subprocess.call([script, out_dir_arg])
        _check_pproc(pf, log, code)


def _check_pproc(pf: ParamFile, log: RunLog, code: int) -> None:
    if code != 0:
        log("Warning: postprocessing script returned a nonzero exit status (%d).\n", code)
        if pf.flag("pproc_nofail"):
            raise IntertrackError("postprocessing failed (pproc_nofail set)")


def _device_summary(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="intertrack",
        description="Freezing/thawing phase-field simulator (PyTorch/CUDA)")
    ap.add_argument("param_file")
    ap.add_argument("positional", nargs="*",
                    help="[master_rank] [ubound_list] (reference CLI compat; "
                         "master_rank is ignored)")
    ap.add_argument("--precision", choices=["f32", "f64"], default="f64",
                    help="field dtype; the controller scalars are f64 always")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, raises without a GPU) or 'cpu'")
    ap.add_argument("--mesh", default=None,
                    help="device mesh spec over the visible devices of "
                         "--device, e.g. 'z', 'z4' or 'z2,y2' (f32)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = field_dtype(args.precision)

    # reference CLI: intertrack param_file [master_rank] [ubound_list]
    ubound_list = ""
    extra = list(args.positional)
    if extra and extra[0].isdigit() and "," not in extra[0]:
        extra.pop(0)  # master_rank — meaningless here
    if extra:
        ubound_list = extra.pop(0)

    ubounds = [int(u) for u in ubound_list.split(",") if u] if ubound_list else []
    with open(args.param_file) as f:
        text = f.read()

    # peek at the logfile setting before full parsing so early errors land
    # in the log as well
    pre = parse_param_file(text, loop_vars={f"i{q+1}": 1 for q in range(20)}
                           | {"loopIter": 1})
    log = RunLog(pre.setting("logfile"))
    log("INTERTRACK phase interface evolution simulator (PyTorch)\n")
    log("devices: %s\n", _device_summary(device))

    debug_log = None
    children: List[subprocess.Popen] = []
    total_iters = 1
    for u in ubounds:
        total_iters *= u
    if ubounds:
        log("\nENTERING BATCH PROCESSING MODE: %d loop%s defined, %d iterations in total.\n",
            len(ubounds), "s" if len(ubounds) > 1 else "", total_iters)

    status = 0
    for loop_iter, loop_values in batch_iterations(ubounds):
        loop_env = {f"i{q+1}": (loop_values[q] if q < len(loop_values) else 1)
                    for q in range(20)}
        loop_env["loopIter"] = loop_iter
        if ubounds:
            log("\nSTARTING ITERATION %d OF %d:\n"
                "----------------------------------------------------------------------\n",
                loop_iter, total_iters)
            for q, v in enumerate(loop_values):
                log("i%d = %d\n", q + 1, v)
        pf = parse_param_file(text, loop_vars=loop_env)
        if pf.skipped:
            log("Iteration %d skipped. Continue...\n", loop_iter)
            continue

        if pf.setting("debug_logfile") and debug_log is None:
            debug_log = RKDebugLog(pf.setting("debug_logfile"),
                                   final_time=pf.get("final_time", 0.0))

        try:
            run_iteration(
                pf, log, device=device, dtype=dtype, loop_iter=loop_iter,
                loop_values=loop_values, loop_ubounds=ubounds or None,
                debug_log=debug_log, mesh_axes=args.mesh)
            out_dir_arg = (pf.setting("out_file")
                           + (loop_suffix(loop_values, ubounds, pf.mnemonics)
                              if ubounds else ""))
            run_pproc(pf, log, out_dir_arg, children)
        except (IntertrackError, ParamError) as exc:
            log("\nError: %s\nStop.\n", exc)
            status = 1
            break

    for child in children:
        child.wait()
    if debug_log is not None:
        debug_log.close()
    log.close()
    return status


if __name__ == "__main__":
    sys.exit(main())
