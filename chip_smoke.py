#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the intertrack solver once on one GPU.

    python3 chip_smoke.py                       # all phases
    python3 chip_smoke.py --phases env,build,kernels

Run from the root of a checkout.  Phases, one JSON line each:

1. env      torch/CUDA versions, the card, nvidia-smi, nvcc, triton
2. build    compile csrc/*.cu with nvcc (sm_90a) and time it
3. kernels  both kernels against their plain PyTorch versions on the card
            (MR, LR and an odd shape; calc modes 0/1/2; t on each side
            of the phase switch; every stage variant), then kernel and
            plain times at the MR shape
4. solve    MR GradP (100x100x200) f32 increment-form attempts through
            merson_solve: kernels, then the plain versions on the card
5. app      the intertrack app on the LR GradP golden case to snapshot 1,
            held to the reference's 3560/4322 steps (5%), with the launch
            counters showing that every attempt went through both kernels

and, only when asked for, ``profile``: torch.profiler over 100 attempts
at LR and at MR (the device's busy share and the time by kernel).

It exits non-zero, before printing the final line, when CUDA is missing or
any phase fails.  The last three lines are the card's name and power
limit (nvidia-smi), the kernel summary, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "solve", "app")
OPTIONAL_PHASES = ("profile",)
SEED = 20251016
# the increment form's golden (reference log, LR GradP snapshot 1)
GOLDEN_STEPS, GOLDEN_ATTEMPTS = 3560, 4322
SOLVE_ATTEMPTS = 300
MR_SHAPE = (200, 100, 100)     # (n3, n2, n1)
LR_SHAPE = (100, 50, 50)       # the app phase's grid
ODD_SHAPE = (19, 23, 37)


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def sh(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable: {exc}"


def nvidia_smi() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])


def phase_env() -> dict:
    nvcc = sh(["nvcc", "--version"]) if shutil.which("nvcc") else sh(
        ["/usr/local/cuda/bin/nvcc", "--version"])
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    info = dict(python=sys.version.split()[0], torch=torch.__version__,
                cuda=torch.version.cuda,
                device=torch.cuda.get_device_name(0),
                device_count=torch.cuda.device_count(),
                nvidia_smi=nvidia_smi(),
                nvcc=nvcc.splitlines()[-1] if nvcc else "",
                triton=triton_version)
    emit("env", **info)
    return info


def phase_build() -> None:
    from porousfreezethaw_tpu_torch.ops.cuda import build
    res = build.build(force=True)
    lib = build.load_library()
    ptxas = [ln.strip() for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=res.seconds, library=str(res.path),
         num_consts=lib.pft_num_consts(), ptxas=ptxas)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _mr_params(grid_nodes=200):
    from porousfreezethaw_tpu_torch.cases import freezing_params_text
    from porousfreezethaw_tpu_torch.config import parse_param_file
    from porousfreezethaw_tpu_torch.models.freezing.parameters import (
        FreezingParams, shift_temperature_origin)
    pf = parse_param_file(freezing_params_text(grid_nodes, 0),
                          env={"OUTPUT": tempfile.gettempdir()})
    prm = FreezingParams.from_dict(pf.vars)
    return pf, shift_temperature_origin(prm, prm.u_star)


def _inputs(shape, dev, rng):
    n3, n2, n1 = shape
    w = np.stack([rng.uniform(-10.0, 10.0, shape), rng.uniform(0.0, 1.0, shape),
                  rng.uniform(0.0, 0.6, shape)]).astype(np.float32)
    ks = [rng.standard_normal((2,) + shape).astype(np.float32)
          for _ in range(3)]
    return (torch.from_numpy(w).to(dev),
            [torch.from_numpy(k).to(dev) for k in ks])


STAGE_CASES = {            # name -> (coefficients, stage5)
    "nk0": ([], False),
    "nk1": ([1 / 3], False),
    "nk2": ([1 / 6, 1 / 6], False),
    "nk3": ([1 / 8, 3 / 8, 0.25], False),
    "stage5": ([0.5, -1.5, 2.0], True),
}
DELTA_CASES = {
    "nk1": ([1 / 3], False),
    "nk2": ([1 / 3, 1 / 6], False),
    "nk3": ([0.5, 0.375, 0.25], False),
    "stage5": ([1.0, -1.5, 2.0], True),
}


def _compare(got, ref, stats):
    """K/G and y_spec: |got - ref| <= 1e-5 |ref| + 1e-5 max|ref|;
    eps: relative 1e-3 + 1e-7 absolute."""
    outs = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    g, r = outs[0][0].double(), outs[1][0].double()
    scale = float(r.abs().max())
    err = (g - r).abs()
    ok = bool(torch.all(err <= 1e-5 * r.abs() + 1e-5 * scale))
    stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))
    stats["max_rel_err"] = max(stats["max_rel_err"],
                               float(err.max()) / max(scale, 1e-30))
    stats["finite"] &= bool(torch.isfinite(g).all())
    if len(outs[0]) == 2:
        a = float(torch.amax(outs[0][1]))
        b = float(torch.amax(outs[1][1]))
        eps_ok = abs(a - b) <= 1e-3 * abs(b) + 1e-7
        stats["max_eps_rel_err"] = max(stats["max_eps_rel_err"],
                                       abs(a - b) / max(abs(b), 1e-30))
        ok = ok and eps_ok
    stats["ok"] &= ok
    stats["n"] += 1


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev) -> dict:
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import physics
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    _, prm = _mr_params()
    rng = np.random.default_rng(SEED)
    h = 0.05
    summary = {"fused_stage": [], "delta_g": []}
    for shape in (MR_SHAPE, LR_SHAPE, ODD_SHAPE):
        geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
        w, ks = _inputs(shape, dev, rng)
        per = {("fused_stage", c): dict(ok=True, finite=True, n=0,
                                        max_abs_err=0.0, max_rel_err=0.0,
                                        max_eps_rel_err=0.0)
               for c in STAGE_CASES}
        per.update({("delta_g", c): dict(ok=True, finite=True, n=0,
                                         max_abs_err=0.0, max_rel_err=0.0,
                                         max_eps_rel_err=0.0)
                    for c in DELTA_CASES})
        for mode in (0, 1, 2):
            spec = st.StencilSpec.of(geom, prm, mode)
            # one t below the switch whose step crosses it, one above
            for t in (prm.phase_switch_time - 0.5 * h,
                      prm.phase_switch_time + 1.0):
                for name, (cs, s5) in STAGE_CASES.items():
                    kk = list(zip(cs, ks))
                    got = st.fused_stage(spec, t, h, w, kk, stage5=s5)
                    ref = st.fused_stage_plain(spec, t, h, w, kk, stage5=s5)
                    _compare(got, ref, per[("fused_stage", name)])
                D1 = physics.dirichlet_top(t, prm)
                dDi = float(np.float32(physics.dirichlet_top(t + h, prm) - D1))
                for name, (cs, s5) in DELTA_CASES.items():
                    kk = list(zip(cs, ks))
                    got = st.delta_g(spec, h, D1, dDi, w, kk, stage5=s5)
                    ref = st.delta_g_plain(spec, h, D1, dDi, w, kk, stage5=s5)
                    _compare(got, ref, per[("delta_g", name)])
        torch.cuda.synchronize()
        for (kern, case), s in per.items():
            emit("kernels", shape=list(shape), kernel=kern, case=case,
                 modes=[0, 1, 2], **s)
            summary[kern].append(s)
            if not (s["ok"] and s["finite"]):
                raise AssertionError(
                    f"{kern} {case} at {shape} disagrees with its plain "
                    f"version: {s}")

    # times at the MR shape, the main path's variants
    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    w, ks = _inputs(MR_SHAPE, dev, rng)
    spec = st.StencilSpec.of(geom, prm, 0)
    t = 1000.0
    D1 = physics.dirichlet_top(t, prm)
    timing = {}
    for impl, f_stage, f_delta in (("plain", st.fused_stage_plain,
                                    st.delta_g_plain),
                                   ("kernel", st.fused_stage, st.delta_g),
                                   ("kernel2", st.fused_stage, st.delta_g),
                                   ("plain2", st.fused_stage_plain,
                                    st.delta_g_plain)):
        row = {}
        for name, (cs, s5) in STAGE_CASES.items():
            kk = list(zip(cs, ks))
            row[f"fused_stage/{name}"] = _time(
                lambda: f_stage(spec, t, h, w, kk, stage5=s5), 10)
        for name, (cs, s5) in DELTA_CASES.items():
            kk = list(zip(cs, ks))
            row[f"delta_g/{name}"] = _time(
                lambda: f_delta(spec, h, D1, 0.0, w, kk, stage5=s5), 10)
        timing[impl] = row
        emit("kernel_times", impl=impl, shape=list(MR_SHAPE), ms=row)
    out = {}
    for kern, cases, replaces, src in (
            ("fused_stage", ["nk0"], ":737", "fused_stage.cu"),
            ("delta_g", list(DELTA_CASES), ":1112", "delta_g.cu")):
        def avg(impl_a, impl_b):
            return float(np.mean([timing[i][f"{kern}/{c}"]
                                  for i in (impl_a, impl_b) for c in cases]))
        out[kern] = dict(
            name=kern, route="cuda",
            source=f"porousfreezethaw_tpu_torch/csrc/{src}",
            replaces=f"porousfreezethaw_tpu/ops/pallas/stencil.py{replaces}",
            launches=0,
            max_abs_err=max(s["max_abs_err"] for s in summary[kern]),
            max_rel_err=max(s["max_rel_err"] for s in summary[kern]),
            ms=avg("kernel", "kernel2"), plain_ms=avg("plain", "plain2"))
    return out


# --------------------------------------------------------------------------
# phase 4: MR GradP solve
# --------------------------------------------------------------------------

def _mr_state(dev, grid_nodes=200):
    """The GradP benchmark case's initial state (u - u*, f32; MR at 200
    grid nodes) on ``dev``, its geometry, the shifted parameters, the
    Params values and h0 = min(tau, 1e-4)."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import (
        FreezingParams, build_glass_field, build_initial_conditions,
        read_ball_positions)

    pf, prm = _mr_params(grid_nodes)
    v = pf.vars
    geom = GridGeometry(v["L1"], v["L2"], v["L3"], int(v["n1"]),
                        int(v["n2"]), int(v["n3"]))
    # the unshifted parameters build the initial state, as the app does
    prm0 = FreezingParams.from_dict(v)
    w0 = build_initial_conditions(geom, prm0, pf.icond_formulas,
                                  dtype=np.float32)
    balls = read_ball_positions(
        os.path.join(REPO, "data", "spheres_positions.txt"), prm0)
    w0[2] = build_glass_field(geom, prm0, balls, w0[2])
    w0[0] -= prm0.u_star
    y0 = torch.from_numpy(np.ascontiguousarray(w0)).to(dev)
    return geom, prm, v, y0, min(v["tau"], 1e-4)


def _check_attempt(geom, prm, t, h, y, where):
    """One attempt on a real state: the kernels' stage chain against the
    plain versions' chain (each fed its own K1 and G's, as in a solve).

    y_spec: 1e-5 of max|y_spec|.  eps: 1e-3 relative plus 4 f32 ulps of
    the largest G entering it — on a real state at small h the estimate
    sits only some ulps of the G's above zero (at the MR initial state,
    h = 1e-4: eps 3e-5 against |G5| 27, i.e. 16 ulps), so the kernels'
    contracted multiply-adds move it by percents of itself."""
    from porousfreezethaw_tpu_torch.models.freezing import physics
    from porousfreezethaw_tpu_torch.ops.cuda.stencil import (
        make_delta_g, make_fused_stage)

    D1 = physics.dirichlet_top(t, prm)
    dD = lambda ts: float(np.float32(physics.dirichlet_top(ts, prm) - D1))
    out = {}
    for impl in ("kernel", "plain"):
        stage = make_fused_stage(geom, prm, 0, plain=(impl == "plain"))
        g = make_delta_g(geom, prm, 0, plain=(impl == "plain"))
        K1 = stage(t, h, y, [])
        G2 = g(h, D1, dD(t + h / 3), y, [(1.0 / 3.0, K1)])
        G3 = g(h, D1, dD(t + h / 3), y, [(1.0 / 3.0, K1), (1.0 / 6.0, G2)])
        G4 = g(h, D1, dD(t + h / 2), y, [(0.5, K1), (0.375, G3)])
        y_spec, eps = g(h, D1, dD(t + h), y,
                        [(1.0, K1), (-1.5, G3), (2.0, G4)], stage5=True)
        gmax = max(float(G3.abs().max()), float(G4.abs().max()))
        out[impl] = (y_spec, float(torch.amax(eps)), gmax)
    (ys_k, a, _), (ys_p, b, gmax) = out["kernel"], out["plain"]
    err = float((ys_k.double() - ys_p.double()).abs().max())
    scale = float(ys_p.abs().max())
    ulp = float(np.spacing(np.float32(gmax)))
    res = dict(where=where, h=h, eps_kernel=a, eps_plain=b, max_G=gmax,
               y_spec_max_abs_err=err, y_spec_scale=scale)
    emit("solve_check", **res)
    if not (abs(a - b) <= 1e-3 * abs(b) + 4 * ulp and err <= 1e-5 * scale):
        raise AssertionError(f"attempt at {where}: kernels and plain "
                             f"versions disagree: {res}")


def phase_solve(dev) -> dict:
    from porousfreezethaw_tpu_torch.ops.cuda.stencil import DeltaAttempt
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MAX_STEPS, MersonParams, merson_init, merson_solve)

    geom, prm, v, y0, h0 = _mr_state(dev)
    _check_attempt(geom, prm, 0.0, h0, y0, "initial state")
    results = {}
    for impl in ("kernel", "plain"):
        att = DeltaAttempt(geom, prm, 0, plain=(impl == "plain"))
        warm = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                            handle_nan=True, max_steps=20)
        state, status = merson_solve(None, merson_init(y0, 0.0, h0), 1e9,
                                     warm, attempt_fn=att)
        torch.cuda.synchronize()
        if impl == "kernel":
            _check_attempt(geom, prm, state.t, state.h, state.y,
                           "after 20 attempts")
        params = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                              handle_nan=True, max_steps=SOLVE_ATTEMPTS)
        t0 = time.perf_counter()
        before = state.steps_total
        state, status = merson_solve(None, state, 1e9, params,
                                     attempt_fn=att)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = state.steps_total - before
        if status != MAX_STEPS or done != SOLVE_ATTEMPTS:
            raise AssertionError(f"solve ({impl}) status {status}, "
                                 f"{done} attempts")
        if not bool(torch.isfinite(state.y).all()):
            raise AssertionError(f"solve ({impl}) produced non-finite state")
        results[impl] = dict(
            attempts=done, steps=state.steps, t=state.t, h=state.h,
            wall_s=wall, ms_per_attempt=1e3 * wall / done,
            cell_rhs_evals_per_s=5.0 * geom.num_cells * done / wall)
        emit("solve", impl=impl, grid=list(geom.shape), **results[impl])
    return results


def phase_profile(dev) -> None:
    """Optional (not in the default run): torch.profiler over a short
    window of attempts at LR (100 grid nodes) and MR, for the device's
    busy share and the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from porousfreezethaw_tpu_torch.ops.cuda.stencil import DeltaAttempt
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    for grid_nodes in (100, 200):
        geom, prm, v, y0, h0 = _mr_state(dev, grid_nodes)
        att = DeltaAttempt(geom, prm, 0)
        state, _ = merson_solve(None, merson_init(y0, 0.0, h0), 1e9,
                                MersonParams(delta=v["delta"],
                                             handle_nan=True, max_steps=40),
                                attempt_fn=att)
        torch.cuda.synchronize()
        n = 100
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = merson_solve(None, state, 1e9,
                                    MersonParams(delta=v["delta"],
                                                 handle_nan=True,
                                                 max_steps=n),
                                    attempt_fn=att)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((float(us), e.key, e.count))
        rows.sort(reverse=True)
        device_us = sum(r[0] for r in rows)
        measured = bool(rows) and device_us > 0
        emit("profile", grid=list(geom.shape), attempts=n, wall_us=wall_us,
             device_us=device_us if measured else "not measured",
             device_busy_share=(device_us / wall_us if measured
                                else "not measured"),
             top=[dict(kernel=k[:80], count=c, us=us)
                  for us, k, c in rows[:10]])
        # the same window unprofiled: the profiler's own cost
        t0 = time.perf_counter()
        merson_solve(None, state, 1e9,
                     MersonParams(delta=v["delta"], handle_nan=True,
                                  max_steps=n), attempt_fn=att)
        torch.cuda.synchronize()
        emit("profile_off", grid=list(geom.shape), attempts=n,
             wall_us=1e6 * (time.perf_counter() - t0))


# --------------------------------------------------------------------------
# phase 5: the app on the LR GradP golden
# --------------------------------------------------------------------------

def phase_app(dev) -> dict:
    from porousfreezethaw_tpu_torch.apps.intertrack import main
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    text = open(os.path.join(REPO, "tests", "golden",
                             "Params-LR-GradP")).read()
    text = re.sub(r"final_time\s+\S+", "final_time 10*hours/99", text)
    text = re.sub(r"saved_files\s+\S+", "saved_files 2", text)
    text += ("\nset ball_positions_file = "
             + os.path.join(REPO, "data", "spheres_positions.txt") + "\n")
    out = tempfile.mkdtemp(prefix="pft_chip_smoke_")
    old = os.environ.get("OUTPUT")
    try:
        pfile = os.path.join(out, "Params")
        with open(pfile, "w") as f:
            f.write(text)
        os.environ["OUTPUT"] = out
        st.fused_stage.launches = 0
        st.delta_g.launches = 0
        t0 = time.perf_counter()
        rc = main([pfile, "--precision", "f32", "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_stage": st.fused_stage.launches,
                    "delta_g": st.delta_g.launches}
        log = open(os.path.join(out, "intertrack.log")).read()
        files = sorted(f for f in os.listdir(out) if f.endswith(".ncd"))
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
        shutil.rmtree(out, ignore_errors=True)
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    sw = re.search(r"Solver wall time: (\S+)", log)
    solver_s = None
    if sw:
        hh, mm, ss = sw[1].split(":")
        solver_s = 3600 * int(hh) + 60 * int(mm) + float(ss)
    res = dict(rc=rc, files=files, launches=launches, wall_s=wall,
               solver_wall_s=solver_s,
               steps=int(m[1]) if m else None,
               attempts=int(m[2]) if m else None,
               reference=[GOLDEN_STEPS, GOLDEN_ATTEMPTS])
    if solver_s and res["attempts"]:
        res["ms_per_attempt"] = 1e3 * solver_s / res["attempts"]
    emit("app", **res)
    if rc != 0 or not m:
        raise AssertionError(f"app failed (rc={rc}):\n{log[-2000:]}")
    if files != ["image.000.ncd", "image.001.ncd"]:
        raise AssertionError(f"snapshots written: {files}")
    steps, attempts = res["steps"], res["attempts"]
    if (abs(steps - GOLDEN_STEPS) > 0.05 * GOLDEN_STEPS
            or abs(attempts - GOLDEN_ATTEMPTS) > 0.05 * GOLDEN_ATTEMPTS):
        raise AssertionError(f"golden steps {steps}/{attempts} not within "
                             f"5% of {GOLDEN_STEPS}/{GOLDEN_ATTEMPTS}")
    if (launches["fused_stage"] != attempts
            or launches["delta_g"] != 4 * attempts):
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{attempts} attempts")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + OPTIONAL_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(OPTIONAL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    dev = torch.device("cuda:0")
    # plain float32 everywhere: no TF32 in any matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels = None
    launches = None
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels = phase_kernels(dev)
    if "solve" in phases:
        phase_solve(dev)
    if "app" in phases:
        launches = phase_app(dev)
    if "profile" in phases:
        phase_profile(dev)

    if kernels is not None and launches is not None:
        for name, n in launches.items():
            kernels[name]["launches"] = n
            if n <= 0:
                raise AssertionError(f"{name} was not launched on the main "
                                     "path")
    if phases != list(PHASES):
        return 0               # partial runs print no result line
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
