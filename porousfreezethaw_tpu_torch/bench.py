"""Benchmark harness of the port: freezing-stencil throughput on one GPU.

    python -m porousfreezethaw_tpu_torch.bench [--fused stage|delta|attempt|off]
        [--dtype f32|f64] [--grid-nodes 200] [--calc-mode 0] [--steps N]
        [--warm-steps N] [--device cuda|cpu] [--profile-dir DIR]
        [--mesh SPEC [--no-overlap]]
    python -m porousfreezethaw_tpu_torch.bench --matrix [--out FILE]

The counterpart of the JAX package's ``bench.py`` freezing suite: the
adaptive Runge-Kutta-Merson solve of the freezing benchmark case
(``cases.freezing_params_text``, GradP by default, on the reference's MR
grid 100 x 100 x 200) with the shipped Params physics and initial
conditions, warmed into the stepping regime, then timed.  The case set-up,
the u - u* shift of f32 runs, h0 = min(tau, 1e-4), the automatic step
counts, the Merson parameters, the metric names, the unit and
``vs_baseline`` (against the C reference's sustained throughput on its CPU
cluster, BASELINE.md) are those of ``bench.py``.  It prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "cell*RHS-evals/s/chip",
     "vs_baseline": N/baseline, "ms_per_attempt": ..., "device": ..., ...}

``--fused`` picks the solver path: ``stage`` (``on``) the classic stage
kernel with its stage-5 tail, ``delta`` the increment-form attempt,
``attempt`` the double-buffered attempt, ``off`` the plain PyTorch
right-hand side (the f64 path); ``auto`` is ``stage`` for f32 on the GPU
and ``off`` otherwise.  ``--device cuda`` is the default and raises
without a GPU; nothing falls back to the CPU.

``--mesh`` benches the sharded paths over a mesh of the visible devices of
``--device``, as ``bench.py`` does: a z mesh the classic stage kernels
(``make_sharded_fused_stage``, with the interior/edge overlap split unless
``--no-overlap``), a mesh with a y axis the 2-D increment-form attempt
(``ShardedDeltaAttempt2D``); the metric gets ``_sharded_<spec>``.

``--matrix`` runs the LR/MR/HR x GradP/SigmaP1-P/Temp rows, the MR GradP
delta row and the MR GradP mesh rows (``z1`` and ``z1,y1``), each in its
own process, and prints one JSON line per row and the MR GradP row again as
the last line.  The matrix's DEM rows and ``--suite dem`` are not ported
yet and raise.  The matrix writes a file only where ``--out`` names one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .cases import freezing_params_text
from .config import parse_param_file
from .core.device import field_dtype, numpy_dtype, resolve_device
from .core.grid import GridGeometry
from .models.freezing import (
    FreezingParams, build_glass_field, build_initial_conditions, make_rhs,
    read_ball_positions, shift_temperature_origin)
from .ops.cuda.stencil import DeltaAttempt, FusedAttempt, make_fused_stage
from .parallel.fused import ShardedDeltaAttempt2D, make_sharded_fused_stage
from .parallel.sharding import make_mesh, shard_freezing_state
from .solvers.merson import MersonParams, merson_init, merson_solve

# the C reference's sustained throughput per case, cells x attempted steps
# x 5 stages / wall seconds from its shipped logs (BASELINE.md), as in
# bench.py
BASELINES = {
    # (grid_nodes, calc_mode): evals/s
    (100, 0): 1.12e8,   # LR GradP, 32 cores (2:42:11, 870,988 att)
    (100, 1): 1.19e8,   # LR SigmaP1-P, 32 cores (1:10:38, 404,490 att)
    (100, 2): 3.11e8,   # LR Temp, 32 cores (0:23:48, 355,469 att)
    (200, 0): 2.40e8,   # MR GradP PhysRevE, 32 cores (23:57:27, 2,073,396)
    (200, 1): 2.45e8,   # MR SigmaP1-P PhysRevE, 32 cores (18:51:51)
    (200, 2): 2.00e8,   # MR Temp PhysRevE, 32 cores (20:33:06)
    (400, 1): 1.79e9,   # HR SigmaP1-P smallsigma, 384 cores (90:30:55)
    (400, 2): 1.22e9,   # HR Temp, 224 cores (104:47:12)
    (400, 0): None,     # no HR GradP reference run exists
}
MODE_NAMES = {0: "gradp", 1: "sigmap", 2: "temp"}
GRID_NAMES = {100: "lr", 200: "mr", 400: "hr"}
UNIT = "cell*RHS-evals/s/chip"
HEADLINE = "freezing_gradp_cell_rhs_evals_per_s"
REPO_BALLS = (Path(__file__).resolve().parents[1] / "data"
              / "spheres_positions.txt")
KERNEL_PATHS = ("stage", "delta", "attempt")


class NotPortedError(NotImplementedError):
    pass


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def metric_name(grid_nodes: int, calc_mode: int) -> str:
    """bench.py's rule: the MR GradP row is the headline metric."""
    if grid_nodes == 200 and calc_mode == 0:
        return HEADLINE
    return (f"freezing_{MODE_NAMES[calc_mode]}_"
            f"{GRID_NAMES.get(grid_nodes, grid_nodes)}_cell_rhs_evals_per_s")


def solver_path(fused: str, dtype: torch.dtype, device: torch.device) -> str:
    """The path ``--fused`` names: 'stage', 'delta', 'attempt' or 'off'."""
    path = {"on": "stage", "auto": ("stage" if dtype == torch.float32
                                    and device.type == "cuda" else "off")
            }.get(fused, fused)
    if path in KERNEL_PATHS and dtype != torch.float32:
        raise ValueError(f"--fused {fused}: the kernels are float32 only; "
                         "f64 runs --fused off")
    return path


def freezing_case(grid_nodes: int, calc_mode: int, dtype: torch.dtype,
                  ball_positions=None):
    """The benchmark case of bench.py: the Params values, the geometry, the
    solver's parameters (shifted to u - u* for f32) and the initial state
    as a numpy array of the field dtype."""
    pf = parse_param_file(
        freezing_params_text(grid_nodes=grid_nodes, calc_mode=calc_mode),
        env={"OUTPUT": tempfile.gettempdir()})
    v = pf.vars
    prm = FreezingParams.from_dict(v)
    geom = GridGeometry(v["L1"], v["L2"], v["L3"], int(v["n1"]), int(v["n2"]),
                        int(v["n3"]))
    icond = dict(pf.icond_formulas)
    if calc_mode == 2:
        icond["p"] = "0"  # Model 2 requires p=0 (reference Params comment)
    w0 = build_initial_conditions(geom, prm, icond, dtype=numpy_dtype(dtype))
    balls = read_ball_positions(str(ball_positions or REPO_BALLS), prm)
    w0[2] = build_glass_field(geom, prm, balls, w0[2])
    if dtype == torch.float32:
        # f32 production conditioning: store u - u_star (exact)
        w0[0] -= prm.u_star
        prm = shift_temperature_origin(prm, prm.u_star)
    return v, geom, prm, np.ascontiguousarray(w0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiled(profile_dir, device: torch.device):
    """torch.profiler over the block, its trace written to
    ``profile_dir/trace.json``; nothing without a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    log(f"profiler trace written to {path}")


def bench_freezing(args, grid_nodes=None, calc_mode=None) -> dict:
    """One timed freezing row; returns its record."""
    grid_nodes = grid_nodes or args.grid_nodes
    calc_mode = args.calc_mode if calc_mode is None else calc_mode
    device = resolve_device(args.device)
    dtype = field_dtype(args.dtype)
    path = solver_path(args.fused, dtype, device)
    if args.mesh and path not in KERNEL_PATHS:
        raise ValueError("--mesh benches the f32 kernel paths (--fused "
                         "stage, delta or attempt; 'auto' on the GPU)")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"device: {device} ({name})")

    v, geom, prm, w0 = freezing_case(grid_nodes, calc_mode, dtype,
                                     args.ball_positions)
    log(f"grid: {geom.n1} x {geom.n2} x {geom.n3} "
        f"({geom.num_cells/1e6:.2f} M cells), calc_mode {calc_mode}, "
        f"dtype {args.dtype}, path {path}")
    rhs = make_rhs(geom, prm, calc_mode, device)
    stage_fn = attempt_fn = mesh = None
    if args.mesh:
        mesh = make_mesh(args.mesh, device=device)
        if "y" in mesh.axis_names:
            attempt_fn = ShardedDeltaAttempt2D(geom, prm, calc_mode, mesh)
            path = "delta_2d"
        else:
            stage_fn = make_sharded_fused_stage(
                geom, prm, calc_mode, mesh, overlap=not args.no_overlap)
            path = "stage_sharded"
        log(f"mesh {mesh.shape}, overlap "
            f"{'off' if args.no_overlap else 'on'}")
    elif path == "stage":
        stage_fn = make_fused_stage(geom, prm, calc_mode)
    elif path == "delta":
        attempt_fn = DeltaAttempt(geom, prm, calc_mode)
    elif path == "attempt":
        attempt_fn = FusedAttempt(geom, prm, calc_mode)

    steps = args.steps or max(20, int(4e8 / geom.num_cells))
    warm = args.warm_steps or min(4 * steps,
                                  max(steps, int(2e9 / geom.num_cells)))
    # NaN backoff on and a tame initial tau (the f32 tau=1 transient
    # overflows the stage cascade); the f32 noise-floor escape only where
    # the intertrack app applies it: classic f32 without an attempt_fn
    params = MersonParams(
        delta=v["delta"], h_min=v["tau_min"], max_steps=steps,
        handle_nan=True,
        accept_growth_min=(1.05 if dtype == torch.float32
                           and attempt_fn is None else 0.0))

    def solve(st):
        return merson_solve(rhs, st, 1e9, params, stage_fn=stage_fn,
                            attempt_fn=attempt_fn)[0]

    y0 = torch.from_numpy(w0).to(device)
    state = merson_init(y0 if mesh is None else shard_freezing_state(y0, mesh),
                        0.0, min(v["tau"], 1e-4))
    log(f"warming >= {warm} attempted steps ({steps} per solver call)...")
    t0 = time.perf_counter()
    for _ in range(max(1, -(-warm // steps))):
        state = solve(state)
    _sync(device)
    log(f"warmup done in {time.perf_counter() - t0:.1f}s "
        f"({state.steps}/{state.steps_total} steps, t={state.t:.4f}s sim, "
        f"h={state.h:.3e})")

    before, before_ok = state.steps_total, state.steps
    with _profiled(args.profile_dir, device):
        _sync(device)
        t0 = time.perf_counter()
        state = solve(state)
        _sync(device)
        wall = time.perf_counter() - t0
    done = state.steps_total - before
    value = 5.0 * geom.num_cells * done / wall
    log(f"{done} attempted steps, t={state.t:.4f}s sim, {wall:.3f}s wall "
        f"-> {value:.3e} cell*RHS-evals/s")
    ys = state.y if mesh is not None else [state.y]
    if not all(bool(torch.isfinite(y).all()) for y in ys):
        raise RuntimeError("the benchmark solve produced a non-finite state")
    base = BASELINES.get((grid_nodes, calc_mode))
    return {
        "metric": metric_name(grid_nodes, calc_mode) + (
            f"_sharded_{args.mesh}" if args.mesh else ""),
        "value": value,
        "unit": UNIT,
        "vs_baseline": (value / base) if base else None,
        "ms_per_attempt": wall / done * 1e3,
        "device": name,
        "fused": path,
        "dtype": args.dtype,
        "grid": [geom.n1, geom.n2, geom.n3],
        "attempts": done,
        "accepted": state.steps - before_ok,
        "warm_attempts": before,
        "mesh": mesh.shape if mesh is not None else None,
    }


# --------------------------------------------------------------------------
# the matrix
# --------------------------------------------------------------------------

def matrix_specs():
    """(row spec, label) of bench.py's matrix; each row runs in its own
    process.  The DEM rows are not ported yet."""
    specs = [(f"freezing:{gn}:{cm}", f"freezing_{gn}_{cm}")
             for gn in (100, 200, 400) for cm in (0, 1, 2)]
    specs.append(("freezing:200:0:delta", "freezing_200_0_delta"))
    specs.append(("freezing:200:0:mesh=z1", "freezing_200_0_sharded"))
    specs.append(("freezing:200:0:mesh=z1,y1", "freezing_200_0_sharded_2d"))
    for n, nb, cap in ((200, "dense", 0), (2000, "dense", 0),
                       (4000, "dense", 0), (4000, "cell_lanes", 8),
                       (6000, "dense", 0), (6000, "cell_lanes", 8),
                       (10000, "cell_lanes", 8), (20000, "cell_lanes", 8)):
        spec = f"dem:{n}:{nb}:512" + (f":{cap}" if cap else "")
        specs.append((spec, f"dem_{n}_{nb}" + (f"_k{cap}" if cap else "")))
    return specs


def bench_row(args, spec: str) -> dict:
    """One matrix row in this process (``--row``)."""
    parts = spec.split(":")
    if parts[0] != "freezing":
        raise NotPortedError(f"matrix row {spec}: the DEM suite is not "
                             "ported yet")
    extra = parts[3] if len(parts) > 3 else ""
    if extra == "delta":
        args.fused = "delta"
    elif extra.startswith("mesh="):
        args.mesh = extra[5:]
    rec = bench_freezing(args, grid_nodes=int(parts[1]),
                         calc_mode=int(parts[2]))
    if extra == "delta":
        rec["metric"] += "_delta"
    return rec


def run_row(spec: str, label: str, args) -> dict:
    """Run one row in a process of its own; a row that fails gives an
    error record."""
    cmd = [sys.executable, "-m", "porousfreezethaw_tpu_torch.bench",
           "--row", spec, "--dtype", args.dtype, "--device", args.device,
           "--steps", str(args.steps), "--warm-steps", str(args.warm_steps)]
    if args.ball_positions:
        cmd += ["--ball-positions", str(args.ball_positions)]
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    out = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if out.stderr:
        log(out.stderr.rstrip()[-2000:])
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if out.returncode != 0:
            rec["rc"] = out.returncode
        return rec
    err = (out.stderr.strip().splitlines() or ["no output"])[-1]
    return {"metric": label, "value": None, "unit": None,
            "vs_baseline": None, "error": err, "rc": out.returncode}


def run_matrix(args) -> int:
    """Print one JSON line per matrix row, then the headline row again;
    write the list to ``args.out`` where it is given.  Returns 1 when a
    ported row failed, else 0."""
    results = []
    failed = False
    for spec, label in matrix_specs():
        rec = run_row(spec, label, args)
        results.append(rec)
        print(json.dumps(rec), flush=True)
        not_ported = "not ported yet" in str(rec.get("error", ""))
        failed |= rec.get("value") is None and not not_ported
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    headline = next((r for r in results if r["metric"] == HEADLINE),
                    {"metric": HEADLINE, "value": None, "unit": None,
                     "vs_baseline": None, "error": "headline row failed"})
    print(json.dumps(headline), flush=True)
    return 1 if failed else 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m porousfreezethaw_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--suite", choices=["freezing", "dem"],
                    default="freezing")
    ap.add_argument("--matrix", action="store_true",
                    help="the LR/MR/HR x GradP/SigmaP/Temp matrix and the "
                         "MR GradP delta row, one JSON line each (each row "
                         "in its own process)")
    ap.add_argument("--out", default=None,
                    help="with --matrix: write the rows to this JSON file")
    ap.add_argument("--row", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--grid-nodes", type=int, default=200,
                    help="cells along the longest side: 100=LR, 200=MR, "
                         "400=HR")
    ap.add_argument("--calc-mode", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=0,
                    help="attempted Merson steps to time (0 = auto)")
    ap.add_argument("--warm-steps", type=int, default=0,
                    help="attempted steps before timing (0 = auto)")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, raises without a GPU) or 'cpu'")
    ap.add_argument("--mesh", default=None,
                    help="bench the sharded kernel paths over a device mesh "
                         "spec (e.g. 'z', 'z1,y1')")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable the interior/edge halo-overlap split")
    ap.add_argument("--ball-positions", default=None)
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the timed section "
                         "into this directory")
    ap.add_argument("--fused", choices=["auto", "attempt", "stage", "delta",
                                        "on", "off"], default="auto",
                    help="'stage' (= 'on') the classic stage kernel with its "
                         "stage-5 tail, 'delta' the increment-form attempt, "
                         "'attempt' the double-buffered attempt, 'off' the "
                         "plain PyTorch right-hand side; 'auto' is 'stage' "
                         "for f32 on the GPU, else 'off'")
    args = ap.parse_args(argv)
    if args.grid_nodes < 4:
        ap.error("--grid-nodes must be >= 4")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.suite == "dem":
        raise NotPortedError("--suite dem: the DEM suite is not ported yet")
    if args.row:
        print(json.dumps(bench_row(args, args.row)), flush=True)
        return 0
    if args.matrix:
        return run_matrix(args)
    print(json.dumps(bench_freezing(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
