#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the intertrack solver once on one GPU.

    python3 chip_smoke.py                       # all phases
    python3 chip_smoke.py --phases env,build,kernels

Run from the root of a checkout.  Phases, one JSON line each:

1. env      torch/CUDA versions, the card, nvidia-smi, nvcc, triton
2. build    compile csrc/*.cu with nvcc (sm_90a, one process per source,
            all started together) and time it
3. kernels  every kernel against its plain PyTorch version on the card
            (MR, LR and an odd shape; calc modes 0/1/2; t on each side
            of the phase switch; every stage variant): fused_stage (K1),
            delta_g (K2), its emit="dy" tail (K2') and the
            double-buffered attempt (K4), which must also equal the
            fused_stage chain bit for bit; then kernel and plain times at
            the MR shape beside each kernel's bound
4. solve    MR GradP (100x100x200) f32 solves of 300 attempts through
            merson_solve, increment form (DeltaAttempt) and classic
            double-buffered (FusedAttempt): kernels, then the plain
            versions on the card
5. bench    the port's bench (porousfreezethaw_tpu_torch.bench) in this
            process: MR GradP f32 with --fused stage, delta and attempt,
            and LR GradP f64 --fused off, with the launch counters of each
6. app      the intertrack app on the LR GradP golden case to snapshot 1,
            plain and with compensated_commit 1, each held to the
            reference's 3560/4322 steps (5%), with the launch counters
            showing that every attempt went through the kernels; then the
            LR Temp golden in f64 (the plain PyTorch path on the card),
            held to 1850/2256 (5%)
7. mesh     the multi-device paths on virtual shards of the card (a mesh
            whose device list repeats cuda:0): the shard kernels K1s
            (fused_stage_shard), K3 (its interior/edge split,
            fused_stage_split), K2s (delta_g_shard) and its emit="dy" tail
            (delta_g_shard_dy) against their plain versions at MR shards;
            sharded against single-device bit for bit at MR on z1, z2,
            z4, z2,y2 and y2 (overlap on and off); their times; MR solves
            of 100 attempts at z4 and z2,y2 against the single-device
            paths (the same counts and state bits); the LR GradP golden
            through run_iteration at z4 (plain and compensated) and
            through the app with --mesh z1, each giving the counts and
            snapshot bytes of the run without a mesh; the bench's MR mesh
            rows

and, only when asked for, ``profile``: torch.profiler over 100 attempts
at LR and at MR, through DeltaAttempt and FusedAttempt, and at MR through
ShardedDeltaAttempt on a z4 mesh of the card (the device's busy share and
the time by kernel).

The launches in the kernel summary come from the run that is each
kernel's main path, with the counters set to 0 just before it: the plain
golden for fused_stage and delta_g, the compensated golden for
delta_g_dy, the bench's --fused attempt row for fused_attempt, the golden
at z4 for fused_stage_split and delta_g_shard, the compensated golden at
z4 for delta_g_shard_dy, the bench's z1,y1 row for fused_stage_shard.

It exits non-zero, before printing the final line, when CUDA is missing or
any phase fails.  The last three lines are the card's name and power
limit (nvidia-smi), the kernel summary, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import argparse
import dataclasses
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
PHASES = ("env", "build", "kernels", "solve", "bench", "app", "mesh")
OPTIONAL_PHASES = ("profile",)
SEED = 20251016
# the increment form's golden (reference log, LR GradP snapshot 1) and the
# f64 golden (reference log, LR Temp snapshot 1; tests/test_golden_lr.py)
GOLDEN_STEPS, GOLDEN_ATTEMPTS = 3560, 4322
TEMP_STEPS, TEMP_ATTEMPTS = 1850, 2256
SOLVE_ATTEMPTS = 300
MR_SHAPE = (200, 100, 100)     # (n3, n2, n1)
LR_SHAPE = (100, 50, 50)       # the app phase's grid
ODD_SHAPE = (19, 23, 37)
# the bound of a kernel call: the larger of its bytes over the H100's HBM
# rate and its float32 operations over the card's float32 rate outside the
# tensor cores (NVIDIA's data sheet, SXM, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float32 operations per cell, counted from the GradP source of
# csrc/stage.cuh and csrc/delta_g.cu and rounded up: the stencil and
# physics, 4 per K input at each of the 5 points a cell combines, and the
# stage-5 tail.  Within 30% or so; every call here is bound by its bytes
# by a factor of 2 or more either way.
STAGE_OPS, DELTA_OPS, OPS_PER_K, TAIL_OPS = 160, 310, 20, 30


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


def _bound(nbytes, ops):
    """(bound_ms, bound_by) of a call moving ``nbytes`` and doing ``ops``
    float32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _call_cost(base_ops, w, kk, n_out, tail):
    """Bytes (each input read once, each output written once) and
    operations of one stage-kernel call on the state ``w`` with the K
    inputs ``kk`` and ``n_out`` output planes."""
    cells = w[0].numel()
    nbytes = 4 * (w.numel() + sum(K.numel() for _, K in kk) + n_out * cells)
    ops = cells * (base_ops + OPS_PER_K * len(kk) + (TAIL_OPS if tail else 0))
    return nbytes, ops


def _stage_chain(spec, t, h, w):
    """The fused_stage kernel's stage-5 chain of one classic attempt on
    ``w``: (y_spec, eps partials, max |K| of the four stages)."""
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    K1 = st.fused_stage(spec, t, h, w, [])
    K2 = st.fused_stage(spec, t + h / 3, h, w, [(1.0 / 3.0, K1)])
    K3 = st.fused_stage(spec, t + h / 3, h, w,
                        [(1.0 / 6.0, K1), (1.0 / 6.0, K2)])
    K4 = st.fused_stage(spec, t + h / 2, h, w,
                        [(1.0 / 8.0, K1), (3.0 / 8.0, K3)])
    y_spec, eps = st.fused_stage(spec, t + h, h, w,
                                 [(0.5, K1), (-1.5, K3), (2.0, K4)],
                                 stage5=True)
    kmax = max(float(K.abs().max()) for K in (K1, K2, K3, K4))
    return y_spec, eps, kmax


def _check_fused_attempt(geom, prm, mode, t, h, w, stats):
    """K4: one double-buffered attempt against the plain FusedAttempt
    (y_spec: 1e-5 as in _compare; eps: 1e-3 relative plus 4 float32 ulps
    of max|K|, the classic estimate cancels K's of that size) and, bit for
    bit, against the fused_stage chain; accept and reject, and gl of both
    slots."""
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    att = st.FusedAttempt(geom, prm, mode)
    ref = st.FusedAttempt(geom, prm, mode, plain=True)
    carry = att.pack(w)
    spec_k, eps = att.attempt(t, h, carry)
    carry_p = ref.pack(w)
    _, eps_p = ref.attempt(t, h, carry_p)
    y_chain, eps_chain, kmax = _stage_chain(st.StencilSpec.of(geom, prm,
                                                              mode), t, h, w)
    got, want = carry[0][1, :2].double(), carry_p[0][1, :2].double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    a, b = float(torch.amax(eps)), float(torch.amax(eps_p))
    ulp = float(np.spacing(np.float32(kmax)))
    ok = (bool(torch.all((got - want).abs() <= 1e-5 * want.abs()
                         + 1e-5 * scale))
          and abs(a - b) <= 1e-3 * abs(b) + 4 * ulp)
    bitwise = (torch.equal(eps, eps_chain)
               and torch.equal(carry[0][1, :2], y_chain)
               and torch.equal(carry[0][0], w)
               and torch.equal(carry[0][1, 2], w[2]))
    rejected = att.unpack(att.commit(spec_k, False))
    bitwise = bitwise and torch.equal(rejected, w)
    accepted = att.unpack(att.commit(spec_k, True))
    bitwise = (bitwise and int(carry[1]) == 1
               and torch.equal(accepted[:2], y_chain)
               and torch.equal(accepted[2], w[2]))
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    stats["max_rel_err"] = max(stats["max_rel_err"], err / max(scale, 1e-30))
    stats["max_eps_rel_err"] = max(stats["max_eps_rel_err"],
                                   abs(a - b) / max(abs(b), 1e-30))
    stats["finite"] &= bool(torch.isfinite(got).all())
    stats["bitwise_vs_stage_chain"] = (stats.get("bitwise_vs_stage_chain",
                                                 True) and bitwise)
    stats["ok"] &= ok and bitwise
    stats["n"] += 1


TIMED_BY = ("; ms: CUDA events over back-to-back wrapper calls, device_ms: "
            "the same calls queued behind a device-side wait (_queued_ms)")
# the device-side wait of _queued_ms: about 25 ms at the H100's clocks
QUEUE_CYCLES = 50_000_000


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
    cases = ([("fused_stage", c) for c in STAGE_CASES]
             + [("delta_g", c) for c in DELTA_CASES]
             + [("delta_g_dy", "stage5"), ("fused_attempt", "attempt")])
    summary = {k: [] for k, _ in cases}
    for shape in (MR_SHAPE, LR_SHAPE, ODD_SHAPE):
        geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
        w, ks = _inputs(shape, dev, rng)
        per = {key: dict(ok=True, finite=True, n=0, max_abs_err=0.0,
                         max_rel_err=0.0, max_eps_rel_err=0.0)
               for key in cases}
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
                kk = list(zip(DELTA_CASES["stage5"][0], ks))
                got = st.delta_g(spec, h, D1, dDi, w, kk, stage5=True,
                                 emit="dy")
                ref = st.delta_g_plain(spec, h, D1, dDi, w, kk, stage5=True,
                                       emit="dy")
                _compare(got, ref, per[("delta_g_dy", "stage5")])
                _check_fused_attempt(geom, prm, mode, t, h, w,
                                     per[("fused_attempt", "attempt")])
        torch.cuda.synchronize()
        for (kern, case), s in per.items():
            emit("kernels", shape=list(shape), kernel=kern, case=case,
                 modes=[0, 1, 2], **s)
            summary[kern].append(s)
            if not (s["ok"] and s["finite"]):
                raise AssertionError(
                    f"{kern} {case} at {shape} disagrees with its plain "
                    f"version: {s}")

    # times at the MR shape, the main paths' variants, beside their bounds
    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    w, ks = _inputs(MR_SHAPE, dev, rng)
    spec = st.StencilSpec.of(geom, prm, 0)
    t = 1000.0
    D1 = physics.dirichlet_top(t, prm)
    s5 = list(zip(DELTA_CASES["stage5"][0], ks))
    atts = {"kernel": st.FusedAttempt(geom, prm, 0),
            "plain": st.FusedAttempt(geom, prm, 0, plain=True)}
    carry = atts["kernel"].pack(w)
    bounds = {}
    for name, (cs, tail) in STAGE_CASES.items():
        kk = list(zip(cs, ks))
        bounds[f"fused_stage/{name}"] = _call_cost(STAGE_OPS, w, kk, 2, tail)
    for name, (cs, tail) in DELTA_CASES.items():
        kk = list(zip(cs, ks))
        bounds[f"delta_g/{name}"] = _call_cost(DELTA_OPS, w, kk, 2, tail)
    bounds["delta_g_dy/stage5"] = _call_cost(DELTA_OPS, w, s5, 2, True)
    # one attempt: stages 1-4 with 0, 1, 2, 2 K inputs, then the tail
    attempt_cost = [_call_cost(STAGE_OPS, w, [(1.0, K) for K in ks[:n]], 2,
                               False) for n in (0, 1, 2, 2)] + [
                        _call_cost(STAGE_OPS, w, s5, 2, True)]
    bounds["fused_attempt/attempt"] = tuple(map(sum, zip(*attempt_cost)))
    # ms: CUDA events over back-to-back wrapper calls, two passes of 10
    # after one warm-up; device_ms: the same calls queued behind a
    # device-side wait (_queued_ms), which leaves out the host's share
    timing = {}
    for impl in ("plain", "kernel", "kernel_device", "kernel2", "plain2"):
        plain = impl.startswith("plain")
        timer = _queued_ms if impl == "kernel_device" else _time
        f_stage = st.fused_stage_plain if plain else st.fused_stage
        f_delta = st.delta_g_plain if plain else st.delta_g
        att = atts["plain" if plain else "kernel"]
        row = {}
        for name, (cs, tail) in STAGE_CASES.items():
            kk = list(zip(cs, ks))
            row[f"fused_stage/{name}"] = timer(
                lambda: f_stage(spec, t, h, w, kk, stage5=tail), 10)
        for name, (cs, tail) in DELTA_CASES.items():
            kk = list(zip(cs, ks))
            row[f"delta_g/{name}"] = timer(
                lambda: f_delta(spec, h, D1, 0.0, w, kk, stage5=tail), 10)
        row["delta_g_dy/stage5"] = timer(
            lambda: f_delta(spec, h, D1, 0.0, w, s5, stage5=True, emit="dy"),
            10)
        # the five launches of one attempt (rejected, so the state stays)
        row["fused_attempt/attempt"] = timer(
            lambda: att.attempt(t, h, carry), 10)
        timing[impl] = row
        emit("kernel_times", impl=impl, shape=list(MR_SHAPE), ms=row)
    emit("kernel_bounds", shape=list(MR_SHAPE),
         bytes={k: b for k, (b, _) in bounds.items()},
         ops={k: o for k, (_, o) in bounds.items()},
         bound_ms={k: _bound(*v)[0] for k, v in bounds.items()})
    out = {}
    for kern, cases, replaces, src in (
            ("fused_stage", ["nk0"], ":737", "fused_stage.cu"),
            ("delta_g", list(DELTA_CASES), ":1112", "delta_g.cu"),
            ("delta_g_dy", ["stage5"], ":1059", "delta_g.cu"),
            ("fused_attempt", ["attempt"], ":1504", "fused_attempt.cu")):
        def avg(*impls):
            return float(np.mean([timing[i][f"{kern}/{c}"]
                                  for i in impls for c in cases]))
        costs = [bounds[f"{kern}/{c}"] for c in cases]
        nbytes = float(np.mean([b for b, _ in costs]))
        ops = float(np.mean([o for _, o in costs]))
        bound_ms, bound_by = _bound(nbytes, ops)
        out[kern] = dict(
            name=kern, route="cuda",
            source=f"porousfreezethaw_tpu_torch/csrc/{src}",
            replaces=f"porousfreezethaw_tpu/ops/pallas/stencil.py{replaces}",
            launches=0,
            max_abs_err=max(s["max_abs_err"] for s in summary[kern]),
            max_rel_err=max(s["max_rel_err"] for s in summary[kern]),
            ms=avg("kernel", "kernel2"), plain_ms=avg("plain", "plain2"),
            bound_ms=bound_ms, bound_by=bound_by,
            # no single PyTorch call computes the stencil right-hand side
            library_ms=None, device_ms=avg("kernel_device"),
            timed=(f"{'+'.join(cases)} at {MR_SHAPE}"
                   + (", one attempt = 5 launches"
                      if kern == "fused_attempt" else ", per launch")
                   + TIMED_BY))
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
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MAX_STEPS, MersonParams, merson_init, merson_solve)

    geom, prm, v, y0, h0 = _mr_state(dev)
    _check_attempt(geom, prm, 0.0, h0, y0, "initial state")
    results = {}
    for path, cls, impl in (("delta", st.DeltaAttempt, "kernel"),
                            ("delta", st.DeltaAttempt, "plain"),
                            ("attempt", st.FusedAttempt, "kernel"),
                            ("attempt", st.FusedAttempt, "plain")):
        att = cls(geom, prm, 0, plain=(impl == "plain"))
        warm = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                            handle_nan=True, max_steps=20)
        state, status = merson_solve(None, merson_init(y0, 0.0, h0), 1e9,
                                     warm, attempt_fn=att)
        torch.cuda.synchronize()
        if (path, impl) == ("delta", "kernel"):
            _check_attempt(geom, prm, state.t, state.h, state.y,
                           "after 20 attempts")
        params = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                              handle_nan=True, max_steps=SOLVE_ATTEMPTS)
        launches = st.fused_attempt.launches
        t0 = time.perf_counter()
        before = state.steps_total
        state, status = merson_solve(None, state, 1e9, params,
                                     attempt_fn=att)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = state.steps_total - before
        if status != MAX_STEPS or done != SOLVE_ATTEMPTS:
            raise AssertionError(f"solve ({path}, {impl}) status {status}, "
                                 f"{done} attempts")
        if not bool(torch.isfinite(state.y).all()):
            raise AssertionError(f"solve ({path}, {impl}) produced "
                                 "non-finite state")
        k4 = st.fused_attempt.launches - launches
        if path == "attempt" and k4 != (5 * done if impl == "kernel" else 0):
            raise AssertionError(f"solve ({path}, {impl}): {k4} K4 launches "
                                 f"for {done} attempts")
        results[(path, impl)] = dict(
            attempts=done, steps=state.steps, t=state.t, h=state.h,
            wall_s=wall, ms_per_attempt=1e3 * wall / done,
            cell_rhs_evals_per_s=5.0 * geom.num_cells * done / wall)
        emit("solve", path=path, impl=impl, grid=list(geom.shape),
             **results[(path, impl)])
    return results


# --------------------------------------------------------------------------
# phase 5: the port's bench
# --------------------------------------------------------------------------

# (--fused, --dtype, --grid-nodes, --steps, --warm-steps)
BENCH_ROWS = (("stage", "f32", 200, 200, 200), ("delta", "f32", 200, 200, 200),
              ("attempt", "f32", 200, 200, 200), ("off", "f64", 100, 20, 5))


def _counters(st) -> dict:
    return {"fused_stage": st.fused_stage.launches,
            "delta_g": st.delta_g.launches,
            "delta_g_dy": st.delta_g.launches_dy,
            "fused_attempt": st.fused_attempt.launches}


def _reset_counters(st) -> None:
    st.fused_stage.launches = st.delta_g.launches = 0
    st.delta_g.launches_dy = st.fused_attempt.launches = 0


def phase_bench(dev) -> dict:
    """The port's bench rows in this process, each record under bench.py's
    metric names with the launch counters of its run; returns the
    counters of the --fused attempt row, the main path of K4."""
    from porousfreezethaw_tpu_torch import bench
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    k4 = None
    for fused, dtype, grid, steps, warm in BENCH_ROWS:
        args = bench.parse_args([
            "--fused", fused, "--dtype", dtype, "--grid-nodes", str(grid),
            "--steps", str(steps), "--warm-steps", str(warm),
            "--device", str(dev)])
        _reset_counters(st)
        rec = bench.bench_freezing(args)
        torch.cuda.synchronize()
        launches = _counters(st)
        emit("bench", **rec, launches=launches)
        n = rec["attempts"] + rec["warm_attempts"]
        want = {"stage": {"fused_stage": 5 * n},
                "delta": {"fused_stage": n, "delta_g": 4 * n},
                "attempt": {"fused_attempt": 5 * n}, "off": {}}[fused]
        want = {k: want.get(k, 0) for k in launches}
        if not (rec["value"] > 0 and rec["metric"].startswith("freezing_")
                and rec["device"] == torch.cuda.get_device_name(dev)):
            raise AssertionError(f"bench row {fused}/{dtype}: {rec}")
        if launches != want:
            raise AssertionError(f"bench row {fused}/{dtype}: launches "
                                 f"{launches}, want {want}")
        if fused == "attempt":
            k4 = launches
    return k4


def phase_profile(dev) -> None:
    """Optional (not in the default run): torch.profiler over a short
    window of attempts at LR (100 grid nodes) and MR, through DeltaAttempt
    and FusedAttempt, and at MR through ShardedDeltaAttempt on a z4 mesh of
    virtual shards of the card, for the device's busy share and the time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from porousfreezethaw_tpu_torch.ops.cuda.stencil import (
        DeltaAttempt, FusedAttempt)
    from porousfreezethaw_tpu_torch.parallel import (
        make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.fused import ShardedDeltaAttempt
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    z4 = make_mesh("z4", [dev] * 4)
    for grid_nodes, cls, mesh in ((100, DeltaAttempt, None),
                                  (200, DeltaAttempt, None),
                                  (100, FusedAttempt, None),
                                  (200, FusedAttempt, None),
                                  (200, ShardedDeltaAttempt, z4)):
        geom, prm, v, y0, h0 = _mr_state(dev, grid_nodes)
        if mesh is None:
            att = cls(geom, prm, 0)
        else:
            att = cls(geom, prm, 0, mesh)
            y0 = shard_freezing_state(y0, mesh)
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
        emit("profile", attempt=cls.__name__, grid=list(geom.shape),
             mesh=None if mesh is None else "z4 on one card",
             attempts=n, wall_us=wall_us,
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
        emit("profile_off", attempt=cls.__name__, grid=list(geom.shape),
             mesh=None if mesh is None else "z4 on one card", attempts=n,
             wall_us=1e6 * (time.perf_counter() - t0))


# --------------------------------------------------------------------------
# phase 6: the app on the LR goldens
# --------------------------------------------------------------------------

def _app_run(dev, golden: str, precision: str, extra: str = "") -> dict:
    """The intertrack app on ``tests/golden/<golden>`` to snapshot 1, with
    the launch counters set to 0 just before it and read just after."""
    from porousfreezethaw_tpu_torch.apps.intertrack import main
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    text = open(os.path.join(REPO, "tests", "golden", golden)).read()
    text = re.sub(r"final_time\s+\S+", "final_time 10*hours/99", text)
    text = re.sub(r"saved_files\s+\S+", "saved_files 2", text)
    text += ("\nset ball_positions_file = "
             + os.path.join(REPO, "data", "spheres_positions.txt") + "\n"
             + extra)
    out = tempfile.mkdtemp(prefix="pft_chip_smoke_")
    old = os.environ.get("OUTPUT")
    try:
        pfile = os.path.join(out, "Params")
        with open(pfile, "w") as f:
            f.write(text)
        os.environ["OUTPUT"] = out
        _reset_counters(st)
        t0 = time.perf_counter()
        rc = main([pfile, "--precision", precision, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counters(st)
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
    res = dict(golden=golden, precision=precision, extra=extra.strip(),
               rc=rc, files=files, launches=launches, wall_s=wall,
               solver_wall_s=solver_s,
               steps=int(m[1]) if m else None,
               attempts=int(m[2]) if m else None)
    if solver_s and res["attempts"]:
        res["ms_per_attempt"] = 1e3 * solver_s / res["attempts"]
    emit("app", **res)
    if rc != 0 or not m:
        raise AssertionError(f"app failed (rc={rc}):\n{log[-2000:]}")
    if files != ["image.000.ncd", "image.001.ncd"]:
        raise AssertionError(f"snapshots written: {files}")
    res["log"] = log
    return res


def _within(res, steps, attempts) -> None:
    if (abs(res["steps"] - steps) > 0.05 * steps
            or abs(res["attempts"] - attempts) > 0.05 * attempts):
        raise AssertionError(
            f"{res['golden']} {res['extra']}: steps "
            f"{res['steps']}/{res['attempts']} not within 5% of "
            f"{steps}/{attempts}")


def phase_app(dev) -> dict:
    """The goldens; returns the launch counters of the main-path runs of
    fused_stage and delta_g (the plain golden) and delta_g_dy (the
    compensated one)."""
    runs = {}
    for key, golden, precision, extra, ref in (
            ("plain", "Params-LR-GradP", "f32", "",
             (GOLDEN_STEPS, GOLDEN_ATTEMPTS)),
            ("compensated", "Params-LR-GradP", "f32",
             "compensated_commit 1\n", (GOLDEN_STEPS, GOLDEN_ATTEMPTS)),
            ("f64", "Params-LR-Temp", "f64", "",
             (TEMP_STEPS, TEMP_ATTEMPTS))):
        res = _app_run(dev, golden, precision, extra)
        _within(res, *ref)
        n = res["attempts"]
        want = {"plain": {"fused_stage": n, "delta_g": 4 * n},
                "compensated": {"fused_stage": n, "delta_g": 3 * n,
                                "delta_g_dy": n},
                "f64": {}}[key]
        want = {k: want.get(k, 0) for k in res["launches"]}
        if res["launches"] != want:
            raise AssertionError(f"{key} golden: launch counts "
                                 f"{res['launches']}, want {want}")
        if key == "compensated" and "(compensated commit)" not in res["log"]:
            raise AssertionError("the app ignored compensated_commit 1")
        runs[key] = res["launches"]
    return {"fused_stage": runs["plain"]["fused_stage"],
            "delta_g": runs["plain"]["delta_g"],
            "delta_g_dy": runs["compensated"]["delta_g_dy"]}


# --------------------------------------------------------------------------
# phase 7: the mesh paths, on virtual shards of the one card
# --------------------------------------------------------------------------

# (spec, shards) of the bitwise checks; the solves use z4 and z2,y2
MESH_SPECS = (("z1", 1), ("z2", 2), ("z4", 4), ("z2,y2", 4), ("y2", 2))
MESH_ATTEMPTS = 100
MESH_KERNELS = ("fused_stage_shard", "fused_stage_split", "delta_g_shard",
                "delta_g_shard_dy")


def _mesh_counters(st) -> dict:
    return {"fused_stage_shard": st.fused_stage_shard.launches,
            "fused_stage_split": st.fused_stage_shard.launches_split,
            "delta_g_shard": st.delta_g_shard.launches,
            "delta_g_shard_dy": st.delta_g_shard.launches_dy}


def _reset_mesh_counters(st) -> None:
    st.fused_stage_shard.launches = st.fused_stage_shard.launches_split = 0
    st.delta_g_shard.launches = st.delta_g_shard.launches_dy = 0


def _all_counters(st) -> dict:
    return {**_counters(st), **_mesh_counters(st)}


def _reset_all(st) -> None:
    _reset_counters(st)
    _reset_mesh_counters(st)


def _shard_case(w, ks, nk, planes, rows):
    """One shard's inputs, planes [lo, hi) and input rows ``rows`` of the
    whole-grid w and ks, with the ghost stacks of the planes around it
    (the own edge planes at a chain end)."""
    lo, hi = planes
    below, above = max(lo - 1, 0), min(hi, w.shape[1] - 1)
    ws = w[:, lo:hi, rows].contiguous()
    kk = [K[:, lo:hi, rows].contiguous() for K in ks[:nk]]
    g = tuple(torch.cat([w[:, p, rows]] + [K[:, p, rows] for K in ks[:nk]])
              .contiguous() for p in (below, above))
    return ws, kk, g


def _shard_cost(base_ops, ws, nk, n_out_rows, tail):
    """Bytes (each input plane, ghost planes included, read once; each
    output written once) and operations of one shard launch."""
    nv, zl, ye, x = ws.shape
    gplanes = 3 + 2 * nk
    nbytes = 4 * (gplanes * zl * ye * x + 2 * gplanes * ye * x
                  + 2 * zl * n_out_rows * x)
    cells = zl * n_out_rows * x
    return nbytes, cells * (base_ops + OPS_PER_K * nk
                            + (TAIL_OPS if tail else 0))


def _mesh_kernels(dev):
    """K1s, K3 and K2s against their plain versions at MR shards; returns
    the error statistics by kernel."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import physics
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    _, prm = _mr_params()
    rng = np.random.default_rng(SEED + 3)
    h = 0.05
    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    w, ks = _inputs(MR_SHAPE, dev, rng)
    stats = {k: dict(ok=True, finite=True, n=0, max_abs_err=0.0,
                     max_rel_err=0.0, max_eps_rel_err=0.0)
             for k in MESH_KERNELS}
    Z, half, zq = MR_SHAPE[0], MR_SHAPE[1] // 2, MR_SHAPE[0] // 4
    # (planes, input rows, window): a z4 shard, and the two y-shards of a
    # z2,y2 mesh (one at each y chain end)
    shards = (((zq, 2 * zq), slice(None), (0, MR_SHAPE[1], 0)),
              ((Z // 2, Z), slice(0, half + 1), (0, half, 0)),
              ((0, Z // 2), slice(half - 1, None), (1, half, half)))
    top = ((Z - zq, Z), slice(None), (0, MR_SHAPE[1], 0))
    for mode in (0, 1, 2):
        spec = st.StencilSpec.of(geom, prm, mode)
        for t in (prm.phase_switch_time - 0.5 * h,
                  prm.phase_switch_time + 1.0):
            for planes, rows, window in shards:
                for cs, s5 in STAGE_CASES.values():
                    ws, kk, g = _shard_case(w, ks, len(cs), planes, rows)
                    kk = list(zip(cs, kk))
                    ref = st.fused_stage_shard_plain(spec, t, h, ws, kk, g,
                                                     window=window, stage5=s5)
                    got = st.fused_stage_shard(spec, t, h, ws, kk, g,
                                               window=window, stage5=s5)
                    _compare(got, ref, stats["fused_stage_shard"])
                    prev = st.fused_stage_shard(
                        spec, t, h, ws, kk, None, window=window, stage5=s5,
                        part="interior")
                    got = st.fused_stage_shard(
                        spec, t, h, ws, kk, g, window=window, stage5=s5,
                        part="edge", prev=prev if s5 else (prev,))
                    _compare(got, ref, stats["fused_stage_split"])
            D1 = physics.dirichlet_top(t, prm)
            dDi = float(np.float32(physics.dirichlet_top(t + h, prm) - D1))
            for (planes, rows, window), is_top in ((shards[0], False),
                                                  (shards[2], False),
                                                  (top, True)):
                for cs, s5 in DELTA_CASES.values():
                    for tail in (("y", "dy") if s5 else ("y",)):
                        ws, kk, g = _shard_case(w, ks, len(cs), planes, rows)
                        args = (spec, h, D1, dDi, ws, list(zip(cs, kk)), g)
                        kw = dict(is_top=is_top, window=window, stage5=s5,
                                  emit=tail)
                        _compare(st.delta_g_shard(*args, **kw),
                                 st.delta_g_shard_plain(*args, **kw),
                                 stats["delta_g_shard_dy" if tail == "dy"
                                       else "delta_g_shard"])
    torch.cuda.synchronize()
    for kern, s in stats.items():
        emit("mesh_kernels", shape=list(MR_SHAPE), kernel=kern,
             modes=[0, 1, 2], **s)
        if not (s["ok"] and s["finite"]):
            raise AssertionError(f"{kern} disagrees with its plain version: "
                                 f"{s}")
    return stats


def _mesh_bitwise(dev):
    """Sharded against single-device, bit for bit, at MR on virtual
    shards: the delta attempt (overlap on and off), the compensated
    attempt and the classic stage-5 tail, t across the phase switch."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.parallel import (
        gather_freezing_state, make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.fused import (
        ShardedDeltaAttempt, ShardedDeltaAttempt2D, make_sharded_fused_stage)

    _, prm = _mr_params()
    rng = np.random.default_rng(SEED + 4)
    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    w, ks = _inputs(MR_SHAPE, dev, rng)
    h = 0.05
    combo = list(zip([0.5, -1.5, 2.0], ks))
    results = []
    for mode in (0, 1, 2):
        for t in (prm.phase_switch_time - 0.01, 1000.0):
            single = st.DeltaAttempt(geom, prm, mode)
            (_, ys_a), eps_a = single.attempt(t, h, single.pack(w))
            comp = st.DeltaAttemptComp(geom, prm, mode)
            (_, dy_a), epsc_a = comp.attempt(t, h, comp.pack(w))
            spec = st.StencilSpec.of(geom, prm, mode)
            yc_a, ec_a = st.fused_stage(spec, t, h, w, combo, stage5=True)
            for ms, n in MESH_SPECS:
                mesh = make_mesh(ms, [dev] * n)
                shards = shard_freezing_state(w, mesh)
                combo_s = [(c, shard_freezing_state(k, mesh))
                           for c, k in combo]
                for overlap in ((True, False) if "y" not in ms
                                else (False,)):
                    if "y" in ms:
                        att = ShardedDeltaAttempt2D(geom, prm, mode, mesh)
                    else:
                        att = ShardedDeltaAttempt(geom, prm, mode, mesh,
                                                  overlap=overlap)
                    (_, ys_b), eps_b = att.attempt(t, h, att.pack(shards))
                    row = dict(mode=mode, t=t, mesh=ms, overlap=overlap,
                               delta=(torch.equal(gather_freezing_state(
                                   ys_b, mesh), ys_a)
                                   and torch.equal(eps_b.max(),
                                                   eps_a.max())))
                    if "y" not in ms:
                        attc = ShardedDeltaAttempt(
                            geom, prm, mode, mesh, overlap=overlap,
                            compensated=True)
                        (_, dy_b), epsc_b = attc.attempt(t, h,
                                                         attc.pack(shards))
                        row["compensated"] = (
                            torch.equal(gather_freezing_state(dy_b, mesh),
                                        dy_a)
                            and torch.equal(epsc_b.max(), epsc_a.max()))
                        stage = make_sharded_fused_stage(
                            geom, prm, mode, mesh, overlap=overlap)
                        ys, e = stage.stage5(t, h, shards, combo_s)
                        row["classic_stage5"] = (
                            torch.equal(gather_freezing_state(ys, mesh),
                                        yc_a)
                            and torch.equal(e.max(), ec_a.max()))
                    results.append(row)
    torch.cuda.synchronize()
    bad = [r for r in results
           if not all(v for k, v in r.items() if k in (
               "delta", "compensated", "classic_stage5"))]
    emit("mesh_bitwise", shape=list(MR_SHAPE), cases=len(results),
         failed=bad)
    if bad:
        raise AssertionError(f"sharded and single-device differ: {bad}")


def _mesh_times(dev):
    """Kernel and plain times of one z4 shard launch at MR (zl = 50), beside
    the bytes bound of the launch; (ms, plain_ms, bound, bytes) by
    kernel."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import physics
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    _, prm = _mr_params()
    rng = np.random.default_rng(SEED + 5)
    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    w, ks = _inputs(MR_SHAPE, dev, rng)
    spec = st.StencilSpec.of(geom, prm, 0)
    t, h = 1000.0, 0.05
    D1 = physics.dirichlet_top(t, prm)
    zq = MR_SHAPE[0] // 4
    planes, rows, win = (zq, 2 * zq), slice(None), (0, MR_SHAPE[1], 0)
    ny = MR_SHAPE[1]
    cases = {}
    ws0, _, g0 = _shard_case(w, ks, 0, planes, rows)
    cases["fused_stage_shard"] = [(
        lambda f: f(spec, t, h, ws0, [], g0, window=win),
        _shard_cost(STAGE_OPS, ws0, 0, ny, False))]

    def split(f):
        prev = f(spec, t, h, ws0, [], None, window=win, part="interior")
        return f(spec, t, h, ws0, [], g0, window=win, part="edge",
                 prev=(prev,))
    cases["fused_stage_split"] = [(split, _shard_cost(STAGE_OPS, ws0, 0, ny,
                                                      False))]
    cases["delta_g_shard"] = []
    for cs, s5 in DELTA_CASES.values():
        ws, kk, g = _shard_case(w, ks, len(cs), planes, rows)
        kk = list(zip(cs, kk))
        cases["delta_g_shard"].append((
            lambda f, ws=ws, kk=kk, g=g, s5=s5: f(
                spec, h, D1, 0.0, ws, kk, g, is_top=False, window=win,
                stage5=s5),
            _shard_cost(DELTA_OPS, ws, len(cs), ny, s5)))
    ws3, kk3, g3 = _shard_case(w, ks, 3, planes, rows)
    kk3 = list(zip(DELTA_CASES["stage5"][0], kk3))
    cases["delta_g_shard_dy"] = [(
        lambda f: f(spec, h, D1, 0.0, ws3, kk3, g3, is_top=False,
                    window=win, stage5=True, emit="dy"),
        _shard_cost(DELTA_OPS, ws3, 3, ny, True))]
    funcs = {"fused_stage_shard": (st.fused_stage_shard,
                                   st.fused_stage_shard_plain),
             "fused_stage_split": (st.fused_stage_shard,
                                   st.fused_stage_shard_plain),
             "delta_g_shard": (st.delta_g_shard, st.delta_g_shard_plain),
             "delta_g_shard_dy": (st.delta_g_shard, st.delta_g_shard_plain)}
    # timed as phase_kernels times K1/K2 (ms and device_ms alike); a shard
    # launch is short enough that the host's wrapper calls, not the card,
    # set the pace of back-to-back launches, which device_ms leaves out
    timing = {}
    for impl in ("plain", "kernel", "kernel_device", "kernel2", "plain2"):
        row = {}
        for kern, calls in cases.items():
            f = funcs[kern][1 if impl.startswith("plain") else 0]
            timer = _queued_ms if impl == "kernel_device" else _time
            row[kern] = float(np.mean([timer(lambda c=c: c(f), 10)
                                       for c, _ in calls]))
        timing[impl] = row
        emit("mesh_kernel_times", impl=impl,
             shard=[zq] + list(MR_SHAPE[1:]), ms=row)
    out = {}
    for kern, calls in cases.items():
        nbytes = float(np.mean([b for _, (b, _) in calls]))
        ops = float(np.mean([o for _, (_, o) in calls]))
        out[kern] = (float(np.mean([timing["kernel"][kern],
                                    timing["kernel2"][kern]])),
                     float(np.mean([timing["plain"][kern],
                                    timing["plain2"][kern]])),
                     _bound(nbytes, ops), nbytes,
                     timing["kernel_device"][kern])
    return out


def _queued_ms(fn, reps):
    """Device time per call of ``fn``'s launches: CUDA events around
    ``reps`` calls queued behind a device-side wait (torch.cuda._sleep),
    so the card runs them back to back and the host's time per call is
    hidden; raises if the host took longer to queue them than the wait
    lasted."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(QUEUE_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ev[2].record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    wait_ms = ev[0].elapsed_time(ev[1])
    if host_ms >= 0.8 * wait_ms:
        raise AssertionError(f"queueing {reps} calls took {host_ms} ms, "
                             f"the device-side wait only {wait_ms} ms")
    return ev[1].elapsed_time(ev[2]) / reps


def _mesh_solves(dev):
    """MR GradP f32, MESH_ATTEMPTS attempts from the bench's start state:
    each sharded path against its single-device counterpart, the same
    steps, attempts, t, h and final state bits."""
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.parallel import (
        gather_freezing_state, make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.fused import (
        ShardedDeltaAttempt, ShardedDeltaAttempt2D, make_sharded_fused_stage)
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve)

    geom, prm, v, y0, h0 = _mr_state(dev)
    z4 = make_mesh("z4", [dev] * 4)
    zy = make_mesh("z2,y2", [dev] * 4)
    paths = (
        ("delta_z4", z4, dict(attempt_fn=st.DeltaAttempt(geom, prm, 0)),
         dict(attempt_fn=ShardedDeltaAttempt(geom, prm, 0, z4)), 0.0),
        ("delta_z2,y2", zy, dict(attempt_fn=st.DeltaAttempt(geom, prm, 0)),
         dict(attempt_fn=ShardedDeltaAttempt2D(geom, prm, 0, zy)), 0.0),
        ("compensated_z4", z4,
         dict(attempt_fn=st.DeltaAttemptComp(geom, prm, 0)),
         dict(attempt_fn=ShardedDeltaAttempt(geom, prm, 0, z4,
                                             compensated=True)), 0.0),
        # the classic path with the bench's f32 noise-floor escape
        ("classic_z4_overlap", z4,
         dict(stage_fn=st.make_fused_stage(geom, prm, 0)),
         dict(stage_fn=make_sharded_fused_stage(geom, prm, 0, z4)), 1.05))
    results = {}
    for name, mesh, single, sharded, growth in paths:
        params = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                              handle_nan=True, max_steps=MESH_ATTEMPTS,
                              accept_growth_min=growth)
        rows = {}
        for which, kw, y in (("single", single, y0),
                             ("sharded", sharded,
                              shard_freezing_state(y0, mesh))):
            # a short warm-up from the same state, then the timed solve
            merson_solve(None, merson_init(y, 0.0, h0), 1e9,
                         dataclasses.replace(params, max_steps=5), **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = merson_solve(None, merson_init(y, 0.0, h0), 1e9,
                                    params, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            yy = (gather_freezing_state(state.y, mesh) if which == "sharded"
                  else state.y)
            rows[which] = (state, yy, 1e3 * wall / state.steps_total)
        (a, ya, ms_a), (b, yb, ms_b) = rows["single"], rows["sharded"]
        same = ((a.steps, a.steps_total, a.t, a.h)
                == (b.steps, b.steps_total, b.t, b.h)
                and torch.equal(ya, yb))
        results[name] = dict(steps=b.steps, attempts=b.steps_total, t=b.t,
                             h=b.h, ms_per_attempt=ms_b,
                             single_ms_per_attempt=ms_a, bitwise=same)
        emit("mesh_solve", path=name, grid=list(geom.shape), **results[name])
        if not same or b.steps_total != MESH_ATTEMPTS:
            raise AssertionError(f"mesh solve {name}: sharded "
                                 f"{b.steps}/{b.steps_total} t={b.t}, single "
                                 f"{a.steps}/{a.steps_total} t={a.t}, "
                                 f"state equal {torch.equal(ya, yb)}")
    return results


def _golden_run(dev, extra="", mesh_axes=None, mesh_devices=None,
                cli=True):
    """The LR GradP golden to snapshot 1: through the app's CLI (with
    ``--mesh mesh_axes``), or through ``run_iteration`` with a mesh of
    ``mesh_devices``; the counters are set to 0 just before and read just
    after.  Returns (steps, attempts, snapshot-1 bytes, launches, log)."""
    from porousfreezethaw_tpu_torch.apps.intertrack import main, run_iteration
    from porousfreezethaw_tpu_torch.config import parse_param_file
    from porousfreezethaw_tpu_torch.io.rklog import RunLog
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    text = open(os.path.join(REPO, "tests", "golden",
                             "Params-LR-GradP")).read()
    text = re.sub(r"final_time\s+\S+", "final_time 10*hours/99", text)
    text = re.sub(r"saved_files\s+\S+", "saved_files 2", text)
    text += ("\nset ball_positions_file = "
             + os.path.join(REPO, "data", "spheres_positions.txt") + "\n"
             + extra)
    out = tempfile.mkdtemp(prefix="pft_chip_smoke_mesh_")
    old = os.environ.get("OUTPUT")
    try:
        pfile = os.path.join(out, "Params")
        with open(pfile, "w") as f:
            f.write(text)
        os.environ["OUTPUT"] = out
        _reset_all(st)
        t0 = time.perf_counter()
        if cli:
            rc = main([pfile, "--precision", "f32", "--device", str(dev)]
                      + (["--mesh", mesh_axes] if mesh_axes else []))
        else:
            pf = parse_param_file(text)
            log = RunLog(pf.setting("logfile"))
            run_iteration(pf, log, device=dev, dtype=torch.float32,
                          mesh_axes=mesh_axes, mesh_devices=mesh_devices)
            log.close()
            rc = 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _all_counters(st)
        log = open(os.path.join(out, "intertrack.log")).read()
        snap = open(os.path.join(out, "image.001.ncd"), "rb").read()
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
        shutil.rmtree(out, ignore_errors=True)
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    if rc != 0 or not m:
        raise AssertionError(f"golden run failed (rc={rc}):\n{log[-2000:]}")
    steps, attempts = int(m[1]), int(m[2])
    emit("mesh_golden", extra=extra.strip(), mesh=mesh_axes,
         shards=len(mesh_devices) if mesh_devices else None, cli=cli,
         steps=steps, attempts=attempts, wall_s=wall,
         ms_per_attempt=1e3 * wall / attempts, launches=launches)
    return steps, attempts, snap, launches, log


def _mesh_goldens(dev) -> dict:
    """The LR GradP golden to snapshot 1 without a mesh, with --mesh z1
    through the app, and through run_iteration on a z4 mesh of the card
    (plain and compensated commit): the same counts and a byte-identical
    snapshot 1.  Returns the main-path launches of K3 and K2s (the plain
    z4 run) and K2s-dy (the compensated z4 run)."""
    comp = "compensated_commit 1\n"
    bases = {"": _golden_run(dev), comp: _golden_run(dev, comp)}
    launches = {}
    for extra, mesh_axes, shards, cli in (("", "z1", 1, True),
                                          ("", "z4", 4, False),
                                          (comp, "z4", 4, False)):
        base = bases[extra]
        run = _golden_run(dev, extra, mesh_axes,
                          None if cli else [dev] * shards, cli)
        n = base[1]
        want = {"fused_stage_split": 2 * shards * n,
                "delta_g_shard": (3 if extra else 4) * shards * n,
                "delta_g_shard_dy": shards * n if extra else 0}
        want = {k: want.get(k, 0) for k in run[3]}
        if run[:2] != base[:2] or run[2] != base[2]:
            raise AssertionError(
                f"golden {extra.strip()} --mesh {mesh_axes}: {run[:2]} "
                f"against {base[:2]} without a mesh, snapshot equal "
                f"{run[2] == base[2]}")
        if run[3] != want:
            raise AssertionError(f"golden {extra.strip()} --mesh "
                                 f"{mesh_axes}: launches {run[3]}, want "
                                 f"{want}")
        if mesh_axes == "z4" and not extra:
            launches["fused_stage_split"] = run[3]["fused_stage_split"]
            launches["delta_g_shard"] = run[3]["delta_g_shard"]
        elif mesh_axes == "z4":
            launches["delta_g_shard_dy"] = run[3]["delta_g_shard_dy"]
    return launches


def _mesh_bench(dev) -> int:
    """The bench's MR mesh rows (bench.py's freezing_200_0_sharded and
    _sharded_2d); returns the K1s launches of the z1,y1 row, its main
    path."""
    from porousfreezethaw_tpu_torch import bench
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    k1s = 0
    for mesh in ("z1", "z1,y1"):
        args = bench.parse_args([
            "--grid-nodes", "200", "--steps", "200", "--warm-steps", "200",
            "--device", str(dev), "--mesh", mesh])
        _reset_all(st)
        rec = bench.bench_freezing(args)
        torch.cuda.synchronize()
        launches = _all_counters(st)
        emit("mesh_bench", **rec, launches=launches)
        n = rec["attempts"] + rec["warm_attempts"]
        want = ({"fused_stage_split": 10 * n} if mesh == "z1" else
                {"fused_stage_shard": n, "delta_g_shard": 4 * n})
        want = {k: want.get(k, 0) for k in launches}
        if not (rec["value"] > 0
                and rec["metric"] == bench.HEADLINE + "_sharded_" + mesh):
            raise AssertionError(f"mesh bench row {mesh}: {rec}")
        if launches != want:
            raise AssertionError(f"mesh bench row {mesh}: launches "
                                 f"{launches}, want {want}")
        if mesh == "z1,y1":
            k1s = launches["fused_stage_shard"]
    return k1s


def phase_mesh(dev):
    """The multi-device freezing paths on virtual shards of the card:
    the shard kernels against their plain versions and their times, the
    sharded paths against the single-device ones bit for bit, MR solves,
    the LR golden and the bench's mesh rows.  Returns the kernel summary
    rows of K1s, K3, K2s and K2s-dy and their main-path launches."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.parallel.fused import (
        halo_bytes_per_attempt)

    stats = _mesh_kernels(dev)
    _mesh_bitwise(dev)
    times = _mesh_times(dev)
    _mesh_solves(dev)
    launches = _mesh_goldens(dev)
    launches["fused_stage_shard"] = _mesh_bench(dev)
    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    emit("mesh_halo", grid=list(MR_SHAPE),
         bytes_per_attempt_per_shard={
             "classic_z4": halo_bytes_per_attempt(geom, 4),
             "delta_z4": halo_bytes_per_attempt(geom, 4, delta=True),
             "delta_z2,y2": halo_bytes_per_attempt(geom, 2, 2, delta=True)})
    out = {}
    for kern, replaces, timed in (
            ("fused_stage_shard", ":737", "nk0, part all"),
            ("fused_stage_split", ":642", "nk0, interior + edge"),
            ("delta_g_shard", ":1112", "nk1+nk2+nk3+stage5"),
            ("delta_g_shard_dy", ":1059", "stage5 emit=dy")):
        ms, plain_ms, (bound_ms, bound_by), nbytes, device_ms = times[kern]
        src = ("delta_g.cu" if kern.startswith("delta")
               else "fused_stage.cu")
        out[kern] = dict(
            name=kern, route="cuda",
            source=f"porousfreezethaw_tpu_torch/csrc/{src}",
            replaces=f"porousfreezethaw_tpu/ops/pallas/stencil.py{replaces}",
            launches=launches.get(kern, 0),
            max_abs_err=stats[kern]["max_abs_err"],
            max_rel_err=stats[kern]["max_rel_err"],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, device_ms=device_ms,
            timed=f"{timed} on one z4 shard of {MR_SHAPE} "
                  f"({MR_SHAPE[0] // 4} planes), {nbytes / 1e6:.1f} MB per "
                  f"launch{TIMED_BY}")
    return out, launches


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

    kernels = {}
    launches = {}
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels.update(phase_kernels(dev))
    if "solve" in phases:
        phase_solve(dev)
    if "bench" in phases:
        launches["fused_attempt"] = phase_bench(dev)["fused_attempt"]
    if "app" in phases:
        launches.update(phase_app(dev))
    if "mesh" in phases:
        mesh_kernels, mesh_launches = phase_mesh(dev)
        kernels.update(mesh_kernels)
        launches.update(mesh_launches)
    if "profile" in phases:
        phase_profile(dev)

    for name in set(kernels) & set(launches):
        kernels[name]["launches"] = launches[name]
    if phases != list(PHASES):
        return 0               # partial runs print no result line
    if set(launches) != set(kernels):
        raise AssertionError(f"main-path launches for {sorted(launches)}, "
                             f"kernels {sorted(kernels)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
