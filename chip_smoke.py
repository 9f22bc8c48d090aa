#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the intertrack solver once on one GPU.

    python3 chip_smoke.py                       # all phases
    python3 chip_smoke.py --phases env,build,kernels
    python3 chip_smoke.py --phases env,build,kernels,controller,app
    python3 chip_smoke.py --phases env,dem_cells         # the DEM cell list
    python3 chip_smoke.py --phases env,build,kernels,solve,bench,app,mesh,dem,dem_cells,profile
    python3 chip_smoke.py --phases env,dem_settle   # the DEM settle
    python3 chip_smoke.py --phases env,dem_settle,dem_settle_host  # both loops
    python3 chip_smoke.py --phases env,build,temp_f64_full  # LR Temp f64, 10 h
    python3 chip_smoke.py --phases env,build,hr             # HR, every path
    python3 chip_smoke.py --phases env,build,lr_f32_full,mr_gradp_full,hr_full

Run from the root of a checkout.  Phases, one JSON line each:

1. env      torch/CUDA versions, the card, nvidia-smi, nvcc, triton
2. build    compile csrc/*.cu with nvcc (sm_90a, one process per source,
            all started together) and time it
3. kernels  every kernel against its plain PyTorch version on the card
            (MR, LR, an odd shape and the tiles' edge shapes; calc modes
            0/1/2; t on each side of the phase switch; every stage
            variant): fused_stage (K1), delta_g (K2), its emit="dy" tail
            (K2') and the double-buffered attempt (K4, each launch, and
            a whole attempt, which must also equal the fused_stage chain
            bit for bit); then kernel and
            plain times at the MR shape beside each kernel's bound, each
            row's ptxas report (registers, spills, shared memory), the
            time of one tensor copy moving the row's bytes (copy_ms), and
            a digest of the delta kernels' outputs (_delta_digest); the
            device controller's kernels (csrc/control.cu) against their
            plain versions bit for bit: pft_merson_control on cases of
            every branch of the step control (eps below and above delta,
            0, inf, NaN, a denormal; the NaN backoff and its abort; h_min;
            the growth floor; the trimmed last step and the finish;
            max_steps; trace clipping; the local mode; a backward step;
            the phase switch; a halted block), the same cases on float64
            partials (the DEM's) with one whose peak lies below delta and
            rounds to it in float32, pft_commit in its three modes with
            the flag at 0 and 1 at MR and its float64 copy at the DEM's
            shapes; the _dev entries of the
            stage kernels against their by-value entries at MR bit for
            bit (every stage variant, calc modes 0/1/2, t on each side of
            the switch) and idle on a halted block; the control kernel's
            growth power against the host's and Python's ** on 100000
            values; the two kernels' times beside their bounds, and their
            float64 variants' at the f64 LR golden's shapes (one partial,
            the (3, 100, 50, 50) state) and the copy's at the DEM's short
            solve (n = 200)
4. solve    MR GradP (100x100x200) f32 solves of 300 attempts through
            merson_solve, increment form (DeltaAttempt) and classic
            double-buffered (FusedAttempt): kernels, then the plain
            versions on the card
   controller  the device-resident loop (merson_solve_device: CUDA
            graphs of BLOCK attempts, the control and commit kernels)
            against the host loop (merson_solve) at MR and LR GradP f32,
            for DeltaAttempt, DeltaAttemptComp, FusedAttempt and the
            classic stage path: 300 attempts after a warm-up, status,
            counts, t, h, the record_trace arrays and the state bit for
            bit; ms/attempt of both loops (3 repeats each, in turns, their
            median and spread), device ms/attempt and busy share
            (torch.profiler), the launches (whole blocks of BLOCK
            attempts on the device loop), each kernel's launches in the
            profiler's trace equal to its counter's (a trace that lost
            records is profiled again, _traced_run), the idle-block cost
            of BLOCK, and the growth power against Python's ** and the
            host's on the runs' eps values, with the host's cost of it;
            then the f64 path (PlainAttempt, the f64 app's: on the device
            loop its float64 stage kernel, on the host loop the plain
            right-hand side) at LR Temp, LR GradP and MR GradP (the
            bench's cases): 96 attempts in both loops, 3 repeats each,
            every run bit for bit its loop's first, the two loops' counts
            equal, the state within 1e-10 and t, h and the trace within
            1e-6 (LOOP_GAP_STATE, LOOP_GAP_STEP), with
            ms/attempt, device ms, launches per attempt and per
            right-hand side, the kernel classes' shares (cat,
            reductions, elementwise), the busy share, the capture time,
            the capturing run's memory peak and an idle attempt's cost
5. bench    the port's bench (porousfreezethaw_tpu_torch.bench) in this
            process: MR GradP f32 with --fused stage, delta and attempt
            (the device loop), and LR GradP f64 --fused off (the device
            loop on PlainAttempt's float64 stage kernel), with the launch
            counters of each
6. app      the intertrack app on the LR GradP golden case to snapshot 1,
            plain and with compensated_commit 1, through the app's chunked
            device loop, each held to the reference's 3560/4322 steps (5%)
            and to the card's earlier counts (3637/4309, 3648/4327), with
            the launch counters showing that every attempt went through
            the kernels (whole blocks of BLOCK attempts, plus the idle
            attempt before the capture); the plain golden again through
            the host loop (the app's uses_device_loop patched): the same
            counts, RK debug log lines and snapshot 1; then the LR Temp
            golden in f64 (the float64 stage kernel on the app's device
            loop, PlainAttempt, and the plain right-hand side on its host
            loop), held
            to 1850/2256 (5%), the two loops' counts, RK debug log lines
            and snapshot 1 equal, its idle attempts priced by phase
            controller's LR Temp row; a short run with --profile-dir
            whose trace holds CUDA kernel events
7. mesh     the multi-device paths on virtual shards of the card (a mesh
            whose device list repeats cuda:0): the shard kernels K1s
            (fused_stage_shard), K3 (its interior/edge split,
            fused_stage_split), K2s (delta_g_shard) and its emit="dy" tail
            (delta_g_shard_dy) against their plain versions at MR shards
            (and two at the tiles' edges); their _dev entries (the device
            loop's) against the by-value entries bit for bit at MR shards
            (every stage, the top shard's Dirichlet top, uneven y windows,
            the tiles' edges, calc modes 0/1/2, t on each side of the
            switch) and idle on a halted block; K2s also timed with its
            inputs cold in L2, K3's interior and edge passes each on its
            own, beside one launch's floor; sharded against single-device
            bit for bit at MR on z1, z2, z4, z2,y2, y2 and z2,y3 (y
            windows of unequal height; overlap on and off); their times;
            each mesh path through the device loop (CUDA graphs of BLOCK
            attempts on the shard kernels' _dev entries) and the host loop
            on the same mesh and the single-device device loop, bit for
            bit: MR solves of 100 attempts at z4 (delta, compensated,
            classic with the overlap split) and z2,y2, and of the plain
            halo path (MR classic f32 on z2,y2 and LR GradP f32 with a
            noise field at z2, 64 attempts), with ms/attempt, device
            ms/attempt and busy share of both loops (torch.profiler), the
            capture time and the capturing run's memory peak; the LR
            Temp golden (f64) through run_iteration at z3 (windows of 34,
            33, 33 planes) on the halo device loop, the single-device
            run's counts and snapshot bytes; the LR GradP golden through
            run_iteration at z4 (plain and compensated) and through the
            app with --mesh z1, on the app's chunked device loop, each
            giving the counts and snapshot bytes of the run without a
            mesh; the bench's MR mesh rows on the device loop
8. dem      the spheres DEM (its right-hand side plain PyTorch; the
            control and commit kernels in float64 on the device loop): the
            dense right-hand side of the four variants at n = 200 on the
            card against the port's on the CPU (f64 to 1e-12 of max|ref|
            per leaf, f32 to 1e-5); a short f64 friction_angular solve to
            t = 10 * 8/399 through the device loop (DEMAttempt, CUDA
            graphs) and the host loop on the card, and the host loop on
            the CPU (the two card loops bit for bit, the CPU's counts;
            ms/attempt, device ms, busy share and launches per attempt of
            each loop, the graph's capture time, the idle attempts' cost;
            the main path of commit_f64_dem, the float64 copy at the
            DEM's shape); the
            particle-sharded dense term on virtual shards: its
            right-hand side on p4 bit for bit against one device, and the
            short solve on p2 through the device loop (DEMAttempt on the
            shards' dicts) and the host loop, bit for bit, with the
            single-device counts and state bits and both loops'
            ms/attempt; the bench's dense
            dem_200 and dem_2000 rows (f32, the device loop) at reduced
            steps, with their launches, capture time and peak memory
9. dem_cells  the DEM cell list (models/dem/forces.py): cell_lanes and
            cell_list against the dense term at n = 200 (four variants,
            f64 to 1e-12 of max|dense| per leaf, f32 to 1e-5), at n =
            4000 (f64) and at n = 20000 (f64, against the dense term
            sharded over p20 virtual shards); the dense icond's occupancy
            at 4000-20000 (at most 8); the overflow's NaN (n = 12, K = 8);
            the short solve with cell_lanes through the device loop (state
            within 1e-10 of dense's); the bench's rows dense 4000/6000 and
            cell_lanes K = 8 4000-20000 at reduced attempts through the
            device loop, with device ms and launches per attempt
            (torch.profiler over a block's replay), the capture time and
            peak memory
10. hr       the HR grid (200x200x400, 16.0 M cells) on every
            single-device path: K1, K2, K2' and K4 against their plain
            versions at HR (every variant, calc modes 0/1/2, 1e-5 of
            max|ref|) and their device ms beside the bound; the bench's
            HR rows (bench_freezing, --grid-nodes 400) through the device
            loop: the delta path in calc modes 0 and 2, the compensated
            commit, the classic stage, the double-buffered attempt (96
            attempts, the median of 3 runs) and the f64 plain path (32),
            with ms/attempt, device ms (torch.profiler, bench
            --profile-dir), busy share, capture time and
            torch.cuda.max_memory_allocated; the delta
            path's device loop and host loop bit for bit over 64
            attempts; the app on the HR GradP Params (the LR golden at
            grid_nodes 400, golden_text) to t = 0.5 s, its snapshot 1 read
            back through load_checkpoint

and, only when asked for, ``profile``: torch.profiler over 100 attempts
at LR and at MR, through DeltaAttempt and FusedAttempt, and at MR through
ShardedDeltaAttempt on a z4 mesh of the card (the device's busy share and
the time by kernel); ``dem_settle``: the settle of VALIDATION.md (200
spheres, friction_angular, f64, T = 8, 400 snapshots) through the spheres
app on the card (its device loop, --device-buffer 8), its final positions
and their eps_s at res = 100, held to the reference ensemble (0.60 <
eps_s < 0.72, scripts/dem_settle_bed.py), its counts beside the host
loop's, and its idle attempts; first, the settle's first 32 snapshot
targets through the device loop and the host loop on the card, bit for
bit; ``dem_settle_host``: the whole settle through the app's host loop
(about half an hour on the card), and with ``dem_settle`` in the same
run, its counts at all 400 snapshots and its final positions byte for
byte against the device loop's; ``temp_f64_full``: the shipped LR Temp
case (f64, 10 h, 100 snapshots) through the app's device loop, its
cumulative steps at snapshots 25/50/75/99 and attempts at 99 within 5%
of the reference's (VALIDATION.md) and its ice fraction's peak and end
within 1e-3 of 0.5084 and 0.0506; ``lr_f32_full``: the shipped LR GradP
and LR Temp cases in f32 (the increment form) to snapshot 99 through the
app's device loop, and GradP resumed by continue_series from snapshot
50, each held to the band (below) at every snapshot VALIDATION.md
records, the Temp run's ice fraction as in temp_f64_full;
``mr_gradp_full``: MR GradP (cases.freezing_params_text(200, 0)) in f32
to snapshot 99, in the band; ``hr_full``: HR Temp (the LR Temp golden at
grid_nodes 400) in f32 to snapshot 2, in the band; ``tracing``: the
port's spans (core/tracing.py) at MR f32 (phase_tracing).  The band, at each
recorded snapshot k, for steps and, where recorded, attempts: 0.95
min(ref_k, jax_k) <= port_k <= 1.05 max(ref_k, jax_k), ref the C
reference's cumulative count, jax the JAX package's f32 delta run on the
TPU (band_misses).  Their logs go to chiprun_out/<phase>/, their
snapshots to a temporary directory, removed after (the free disk is
checked first).

The launches in the kernel summary come from the run that is each
kernel's main path, with the counters set to 0 just before it: the plain
golden (the app's device loop) for fused_stage, delta_g, merson_control
and commit, the f64 LR Temp golden (the app's device loop) for
merson_control_f64, commit_f64 and fused_stage_f64 (its fused_stage
launches), the compensated golden for
delta_g_dy, the bench's --fused attempt row for fused_attempt, the golden
at z4 (the app's device loop) for fused_stage_split and delta_g_shard,
the compensated golden at z4 for delta_g_shard_dy, the bench's z1,y1 row
(the device loop) for fused_stage_shard, the DEM's short f64 solve
through the device loop for commit_f64_dem.

It exits non-zero, before printing the final line, when CUDA is missing or
any phase fails.  A run of every phase of PHASES (optional phases may be
added) ends with three lines: the card's name and power limit
(nvidia-smi), the kernel summary, and {"ok": true, "device": ...}; a run
of fewer phases prints none of them.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import gc
import gzip
import hashlib
import itertools
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
PHASES = ("env", "build", "kernels", "solve", "controller", "bench", "app",
          "mesh", "dem", "dem_cells", "hr")
OPTIONAL_PHASES = ("profile", "dem_settle", "dem_settle_host",
                   "temp_f64_full", "lr_f32_full", "mr_gradp_full",
                   "hr_full", "tracing")
SEED = 20251016
# the increment form's golden (reference log, LR GradP snapshot 1) and the
# f64 golden (reference log, LR Temp snapshot 1; tests/test_golden_lr.py)
GOLDEN_STEPS, GOLDEN_ATTEMPTS = 3560, 4322
TEMP_STEPS, TEMP_ATTEMPTS = 1850, 2256
SOLVE_ATTEMPTS = 300
MR_SHAPE = (200, 100, 100)     # (n3, n2, n1)
LR_SHAPE = (100, 50, 50)       # the app phase's grid
ODD_SHAPE = (19, 23, 37)
# shapes at the edges of the tiles of the stage and delta kernels
# (csrc/tile.cuh): x and y smaller than a tile and z than any chunk; x and y
# one or more past a multiple of a tile side; rows that allow 4-byte copies
# only (odd x), 8-byte (x = 26) and 16-byte (x = 52)
EDGE_SHAPES = ((2, 3, 7), (13, 17, 51), (5, 11, 33), (6, 13, 52),
               (9, 21, 26))
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


_START = time.perf_counter()


def emit(phase: str, **kv) -> None:
    """One JSON line of a phase, with the seconds since the script began
    (``at_s``)."""
    print(json.dumps({"phase": phase, **kv,
                      "at_s": round(time.perf_counter() - _START, 1)}),
          flush=True)


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
    emit("build_ptxas", instantiations=_ptxas(res.log))


# the kernel families of the library: their __global__ templates
# <MODE, NK, TAIL, DEV[, T]> and the names of their tails (DEV: the _dev
# entry, "/dev" in the keys of _ptxas; T = double, the stage kernel's
# float64 instantiation, "/f64")
PTXAS_KERNELS = {"delta_g": ("G", "y", "dy"), "fused_stage": ("K", "y"),
                 "fused_attempt": ("K", "y")}


def _ptxas(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel
    instantiation in a build log (``nvcc -Xptxas -v``), by
    "family/mode/nk/tail" (the tile buffers are dynamic shared memory,
    csrc/tile.cuh tile_smem_bytes)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = None
            for fam, tails in PTXAS_KERNELS.items():
                t = re.search(fam + r"_kernelILi(\d+)ELi(\d)ELi(\d)E"
                              r"(?:Lb([01])E)?([fd])?", m.group(1))
                if t:
                    cur = (f"{fam}/{t[1]}/nk{t[2]}/{tails[int(t[3])]}"
                           + ("/dev" if t[4] == "1" else "")
                           + ("/f64" if t[5] == "d" else ""))
                    out[cur] = {}
            if cur is None and re.search(r"(merson_control|commit)_kernel",
                                         m.group(1)):
                cur = m.group(1)[:60]
                out[cur] = {}
            continue
        if cur is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                out[cur][key] = int(m[1])
    return out


def _built_ptxas() -> dict:
    """_ptxas of the log of the library in build/kernels."""
    from porousfreezethaw_tpu_torch.ops.cuda import build
    log = build.BUILD_DIR / (build.LIB_NAME + ".log")
    return _ptxas(log.read_text()) if log.exists() else {}


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


def _check_attempt_launch(spec, t, h, w, kk, tail, stats):
    """One launch of the fused_attempt kernel (K4) against its plain
    version on the same inputs (the state in slot 0 of both slots, the K
    inputs ``kk``): K, or with ``tail`` the y_spec it writes into slot 1
    and its eps partials (_compare)."""
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    outs = []
    for fn in (st.fused_attempt, st.fused_attempt_plain):
        y2 = torch.stack([w, w])
        cur = torch.zeros(1, dtype=torch.int32, device=w.device)
        got = fn(spec, t, h, y2, cur, kk, tail)
        outs.append((y2[1, :2], got) if tail else got)
    _compare(outs[0], outs[1], stats)


def _kernel_cases(dev, prm, shape, rng, ts, modes=(0, 1, 2), chain_h=0.05):
    """Every stage variant of fused_stage, delta_g and fused_attempt (one
    launch each on the same inputs) and delta_g's emit="dy" tail against
    their plain versions at ``shape`` on random inputs, in each calc mode
    of ``modes`` at each t of ``ts`` (fractions of a step h = 0.05 from
    the phase switch); then one whole fused_attempt attempt
    (_check_fused_attempt: against the plain attempt, and the fused_stage
    chain bit for bit) at the step ``chain_h``, t at the same fractions of
    it.  Per (kernel, case), the _compare statistics, which fail the phase
    when a case disagrees.

    The attempt's five stages feed each other, so the plain attempt and
    the kernels' part by their rounding times the chain's growth, which
    goes as h / dx^2: at MR's spacing h = 0.05 keeps it near 1; at HR's
    (half of it) the same h grows a one-ulp change of u to 3e-4 of
    max|y_spec| (tests/test_torch_hr_cases.py), so HR's chain runs at
    chain_h = HR_CHAIN_H, MR's h / dx^2."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import physics
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    h = 0.05
    keys = ([("fused_stage", c) for c in STAGE_CASES]
            + [("delta_g", c) for c in DELTA_CASES]
            + [("delta_g_dy", "stage5")]
            + [("fused_attempt", c) for c in STAGE_CASES]
            + [("fused_attempt", "attempt")])
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    w, ks = _inputs(shape, dev, rng)
    per = {key: dict(ok=True, finite=True, n=0, max_abs_err=0.0,
                     max_rel_err=0.0, max_eps_rel_err=0.0)
           for key in keys}
    for mode in modes:
        spec = st.StencilSpec.of(geom, prm, mode)
        for t in (prm.phase_switch_time + f * h for f in ts):
            for name, (cs, s5) in STAGE_CASES.items():
                kk = list(zip(cs, ks))
                got = st.fused_stage(spec, t, h, w, kk, stage5=s5)
                ref = st.fused_stage_plain(spec, t, h, w, kk, stage5=s5)
                _compare(got, ref, per[("fused_stage", name)])
                _check_attempt_launch(spec, t, h, w, kk, s5,
                                      per[("fused_attempt", name)])
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
        for f in ts:
            _check_fused_attempt(geom, prm, mode,
                                 prm.phase_switch_time + f * chain_h,
                                 chain_h, w,
                                 per[("fused_attempt", "attempt")])
    torch.cuda.synchronize()
    for (kern, case), s in per.items():
        emit("kernels", shape=list(shape), kernel=kern, case=case,
             modes=list(modes), **s)
        if not (s["ok"] and s["finite"]):
            raise AssertionError(
                f"{kern} {case} at {shape} disagrees with its plain "
                f"version: {s}")
    return per


def _kernel_times(dev, prm, shape, rng, impls):
    """Times of the main paths' variants at ``shape`` (calc mode 0, t =
    1000, h = 0.05, random inputs) by ``impls`` ("kernel", "kernel2":
    CUDA events over back-to-back wrapper calls; "kernel_device": the same
    calls queued behind a device-side wait, _queued_ms, which leaves out
    the host's share; "plain", "plain2": the plain versions), each over
    10 calls after one warm-up, and each variant's (bytes, operations):
    ({impl: {variant: ms}}, {variant: (bytes, ops)})."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import physics
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    h = 0.05
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    w, ks = _inputs(shape, dev, rng)
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
    timing = {}
    for impl in impls:
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
        emit("kernel_times", impl=impl, shape=list(shape), ms=row)
    emit("kernel_bounds", shape=list(shape),
         bytes={k: b for k, (b, _) in bounds.items()},
         ops={k: o for k, (_, o) in bounds.items()},
         bound_ms={k: _bound(*v)[0] for k, v in bounds.items()})
    return timing, bounds


# the variants of each kernel's summary row: (kernel, cases, pallas_call
# line, source)
KERNEL_ROWS = (("fused_stage", ["nk0"], ":737", "fused_stage.cu"),
               ("delta_g", list(DELTA_CASES), ":1112", "delta_g.cu"),
               ("delta_g_dy", ["stage5"], ":1059", "delta_g.cu"),
               ("fused_attempt", ["attempt"], ":1504", "fused_attempt.cu"))


def phase_kernels(dev) -> dict:
    _, prm = _mr_params()
    rng = np.random.default_rng(SEED)
    summary = {}
    for shape in (MR_SHAPE, LR_SHAPE, ODD_SHAPE) + EDGE_SHAPES:
        # one t below the switch whose step crosses it, one above
        per = _kernel_cases(dev, prm, shape, rng, (-0.5, 20.0))
        for (kern, _), s in per.items():
            summary.setdefault(kern, []).append(s)

    # times at the MR shape, the main paths' variants, beside their bounds
    timing, bounds = _kernel_times(
        dev, prm, MR_SHAPE, rng,
        ("plain", "kernel", "kernel_device", "kernel2", "plain2"))
    out = {}
    for kern, cases, replaces, src in KERNEL_ROWS:
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
            bound_share=bound_ms / avg("kernel_device"),
            timed=(f"{'+'.join(cases)} at {MR_SHAPE}"
                   + (", one attempt = 5 launches"
                      if kern == "fused_attempt" else ", per launch")
                   + TIMED_BY))
    for kern in out:
        out[kern]["ptxas"] = _row_ptxas(kern)
        out[kern]["copy_ms"] = _copy_ms(out[kern]["bound_ms"], dev)
    out["fused_stage_f64"] = _stage64_row(dev)
    emit("delta_digest", sha256=_delta_digest(dev))
    # the controller's kernels and the _dev entries
    checks = dict(control=_check_control(dev, prm),
                  control_f64=_check_control(dev, prm, wide=True),
                  commit=_check_commit(dev),
                  commit_f64=_check_commit_f64(dev),
                  dev_entries=_check_dev_entries(dev, prm),
                  pow_02=_pow_sweep(dev))
    emit("controller_checks", **checks)
    out.update(_controller_rows(dev, prm, {
        "merson_control": checks["control"]["max_abs_err"],
        "commit": checks["commit"]["max_abs_err"]}))
    out.update(_controller_rows_f64(dev, prm, {
        "merson_control_f64": checks["control_f64"]["max_abs_err"],
        "commit_f64": checks["commit_f64"]["max_abs_err"],
        "commit_f64_dem": checks["commit_f64"]["max_abs_err"]}))
    return out


# the five stages of the f64 attempt: (name, K inputs, tail)
STAGE64_LAUNCHES = (("nk0", 0, False), ("nk1", 1, False), ("nk2", 2, False),
                    ("nk2b", 2, False), ("stage5", 3, True))


def _stage64_row(dev) -> dict:
    """K1-f64: the stage kernel's float64 _dev entry (the f64 path's
    attempt, PlainAttempt's stage-kernel route) at MR in calc mode 0, each
    of an attempt's five launches (t = 1000, h = 0.05, random inputs):
    ms and device ms beside the bound of its bytes and float64 operations
    (the larger of bytes / 3.35 TB/s and operations / 34 TFLOP/s), the
    plain version's ms, the largest error against it over max|ref|; the
    row's figures per launch are the mean of the five, ``attempt`` their
    sum; the ptxas report of the float64 instantiations."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing.parameters import (
        FreezingParams)
    from porousfreezethaw_tpu_torch.ops.cuda import control
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    pf, _ = _mr_params()
    prm = FreezingParams.from_dict(pf.vars)       # f64 holds u absolute
    shape = MR_SHAPE
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    spec = st.StencilSpec.of(geom, prm, 0, torch.float64)
    rng = np.random.default_rng(SEED + 64)
    w = torch.from_numpy(np.stack([
        prm.u_star + rng.uniform(-10.0, 10.0, shape),
        rng.uniform(0.0, 1.0, shape), rng.uniform(0.0, 0.6, shape)])).to(dev)
    ks = [torch.from_numpy(rng.standard_normal((2,) + shape)).to(dev)
          for _ in range(3)]
    n_eps = st._eps_blocks("pft_stage_eps_blocks64", dev, 0, *shape)
    eps = torch.empty(n_eps, dtype=torch.float64, device=dev)
    block = control.ControlBlock(dev, eps)
    c = control.Control(t=1000.0, h=0.05, h_cont=0.05, tf=1e12, delta=1e-3,
                        max_steps=2**62, eps=eps.data_ptr(), eps_n=n_eps,
                        eps_f64=1)
    control.next_scalars_plain(c)
    block.write(c)
    out = torch.empty((2,) + shape, dtype=torch.float64, device=dev)
    cells = int(np.prod(shape))
    launches = {}
    for stage, (name, nk, tail) in enumerate(STAGE64_LAUNCHES):
        kk = list(zip(st.STAGE_COEFS[torch.float64][stage], ks))

        def kernel():
            st.fused_stage_dev(spec, block, stage, w, kk, out, stage5=tail,
                               eps=eps if tail else None)

        def plain():
            return st.fused_stage_plain(
                spec, c.ts64[st.STAGE64_TIME[stage]],
                c.hs[st.STAGE64_SCALE[stage]], w, kk, stage5=tail)

        kernel()
        ref = plain()
        ref = ref[0] if tail else ref
        nbytes = 8 * cells * (3 + 2 * nk + 2)
        ops = cells * (STAGE_OPS + OPS_PER_K * nk + (TAIL_OPS if tail
                                                      else 0))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_FLOP_PER_S
        launches[name] = dict(
            nk=nk, tail=tail, bytes=nbytes, ops=ops,
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=float((out - ref).abs().max()),
            max_rel_err=float((out - ref).abs().max() / ref.abs().max()),
            ms=_time(kernel, 10), device_ms=_queued_ms(kernel, 10),
            plain_ms=_time(plain, 3))
        launches[name]["bound_share"] = (launches[name]["bound_ms"]
                                         / launches[name]["device_ms"])
    torch.cuda.synchronize()

    def total(key):
        return sum(v[key] for v in launches.values())

    row = dict(
        name="fused_stage_f64", route="cuda",
        source="porousfreezethaw_tpu_torch/csrc/fused_stage.cu",
        replaces="none: the f64 path's plain right-hand side "
                 "(models/freezing/equation.py make_rhs over "
                 "solvers/merson.py merson_stages)",
        launches=0,
        max_abs_err=max(v["max_abs_err"] for v in launches.values()),
        max_rel_err=max(v["max_rel_err"] for v in launches.values()),
        ms=total("ms") / 5, plain_ms=total("plain_ms") / 5,
        bound_ms=total("bound_ms") / 5,
        bound_by="bytes" if all(v["bound_by"] == "bytes"
                                for v in launches.values()) else "mixed",
        library_ms=None, device_ms=total("device_ms") / 5,
        bound_share=total("bound_ms") / total("device_ms"),
        attempt=dict(ms=total("ms"), device_ms=total("device_ms"),
                     plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                     bytes=total("bytes")),
        per_launch=launches,
        timed=(f"the five launches of an f64 attempt at {MR_SHAPE}, per "
               "launch the mean" + TIMED_BY),
        ptxas=_row_ptxas("fused_stage_f64"))
    emit("kernel_stage64", **row)
    if row["max_rel_err"] > 1e-13:
        raise AssertionError(f"fused_stage_f64 disagrees with its plain "
                             f"version: {row['max_rel_err']}")
    return row


def _delta_digest(dev) -> str:
    """sha256 of the delta kernels' outputs (K2, K2', and K2s on a z4 shard
    with and without the Dirichlet top; every tail, calc modes 0/1/2/10/11)
    on seeded inputs at MR and at the odd shape, with the eps max of each
    tail.  It uses only the delta wrappers, so running it over another
    tree's package compares the two builds of the kernel bit for bit."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import physics
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    _, prm = _mr_params()
    digest = hashlib.sha256()
    h, t = 0.05, prm.phase_switch_time - 0.025
    D1 = physics.dirichlet_top(t, prm)
    dDi = float(np.float32(physics.dirichlet_top(t + h, prm) - D1))
    for shape in (MR_SHAPE, ODD_SHAPE):
        geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
        w, ks = _inputs(shape, dev, np.random.default_rng(SEED + 7))
        zq = shape[0] // 4
        for mode in (0, 1, 2, 10, 11):
            spec = st.StencilSpec.of(geom, prm, mode)
            for cs, s5 in DELTA_CASES.values():
                for tail in (("y", "dy") if s5 else ("y",)):
                    kk = list(zip(cs, ks))
                    outs = [st.delta_g(spec, h, D1, dDi, w, kk, stage5=s5,
                                       emit=tail)]
                    ws, kz, g = _shard_case(w, ks, len(cs), (zq, 2 * zq),
                                            slice(None))
                    for is_top in (False, True):
                        outs.append(st.delta_g_shard(
                            spec, h, D1, dDi, ws, list(zip(cs, kz)), g,
                            is_top=is_top, stage5=s5, emit=tail))
                    for o in outs:
                        o = o if s5 else (o,)
                        digest.update(o[0].cpu().numpy().tobytes())
                        if s5:
                            digest.update(torch.amax(o[1]).cpu().numpy()
                                          .tobytes())
    return digest.hexdigest()


def _copy_ms(bound_ms, dev):
    """Device ms of one tensor copy that moves the bytes of a bytes bound
    of ``bound_ms`` (half read, half written): the rate the card reaches
    for those bytes, beside the data sheet's."""
    n = int(bound_ms * 1e-3 * HBM_BYTES_PER_S) // 8
    src = torch.ones(n, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms = _queued_ms(lambda: dst.copy_(src), 10)
    emit("copy_baseline", bytes=8 * n, device_ms=ms,
         bytes_per_s=8 * n / (1e-3 * ms))
    return ms


def _row_ptxas(kern: str) -> dict:
    """The ptxas report of the instantiations of the kernel summary row
    ``kern``: the stage kernel's for K1, K1s and K3 (one body), the
    attempt kernel's for K4, the delta kernel's G and y_spec tails for
    delta_g and delta_g_shard and its dy tail for the *_dy rows; all calc
    modes on a line of their own, those of the timed calc mode 0 returned
    for the row."""
    fam = ("delta_g" if kern.startswith("delta_g")
           else "fused_attempt" if kern == "fused_attempt" else "fused_stage")
    tails = (("dy",) if kern.endswith("_dy") else ("G", "y")
             if fam == "delta_g" else ("K", "y"))
    wide = kern.endswith("_f64")      # the stage kernel's float64 row
    mine = {k: v for k, v in _built_ptxas().items()
            if k.split("/")[0] == fam and k.split("/")[3] in tails
            and k.endswith("/f64") == wide}
    emit("ptxas", kernel=kern, instantiations=mine)
    return {k: v for k, v in mine.items() if k.split("/")[1] == "0"}


# --------------------------------------------------------------------------
# phase 3, continued: the controller's kernels (csrc/control.cu) and the
# _dev entries of the stage kernels
# --------------------------------------------------------------------------

# float64 operations outside the tensor cores, H100 SXM (NVIDIA's data
# sheet), for the control kernel's bound
F64_FLOP_PER_S = 34e12
CONTROL_OPS = 200          # float64 operations of one step, counted loosely
EPS_SLOTS = 263            # partials of the control cases


def _control_cases(prm):
    """(name, block fields, eps partials) covering every branch of the
    step control; the partials' max sits at a random slot."""
    rng = np.random.default_rng(SEED + 11)
    t, h = 100.0, 0.05

    def parts(peak):
        p = rng.uniform(0.0, 1e-4, EPS_SLOTS).astype(np.float32)
        if peak == 0.0:
            p[:] = 0.0
        elif np.isfinite(peak):
            p *= np.float32(peak / 1e-4 / 2)
        p[rng.integers(EPS_SLOTS)] = peak
        return p

    nan, inf = float("nan"), float("inf")
    return [
        ("below_delta", {}, parts(2e-4)),
        ("above_delta", {}, parts(5e-3)),
        ("eps_zero", {}, parts(0.0)),
        ("eps_inf", {}, parts(inf)),
        ("eps_nan", {}, parts(nan)),
        ("eps_denormal", {}, parts(1e-44)),
        ("nan_backoff", {"handle_nan": 1}, parts(nan)),
        ("inf_backoff", {"handle_nan": 1}, parts(inf)),
        ("nan_abort", {"handle_nan": 1, "h": 1e-12, "tf": t + 1.0},
         parts(nan)),
        ("nan_at_tf", {"handle_nan": 1, "tf": t}, parts(nan)),
        ("h_min", {"h_min": 0.1}, parts(5e-3)),
        ("growth_floor", {"growth_min": 1.05}, parts(9e-4)),
        ("growth_floor_rejected", {"growth_min": 1.05}, parts(5e-3)),
        ("next_finish", {"tf": t + h + 0.01}, parts(2e-4)),
        ("finish", {"tf": t + h, "finished": 1}, parts(2e-4)),
        ("max_steps", {"max_steps": 11}, parts(2e-4)),
        ("trace_clipped", {"n_trace": 4}, parts(2e-4)),
        ("local_mode", {"local_mode": 1}, parts(3e-2)),
        ("backward", {"h": -h, "h_cont": -h, "tf": -1e9}, parts(2e-4)),
        ("phase_switch", {"t": prm.phase_switch_time - 0.02}, parts(2e-4)),
        ("halted", {"halt": 1, "accept": 1}, parts(2e-4)),
    ]


def _control_block(prm, **kw):
    from porousfreezethaw_tpu_torch.ops.cuda.control import (
        Control, next_scalars_plain)
    c = Control(t=100.0, h=0.05, h_cont=0.05, tf=1e9, delta=1e-3, h_min=0.0,
                growth_min=0.0, top1=prm.top_temp1, top2=prm.top_temp2,
                t_switch=prm.phase_switch_time, steps=40, steps_total=45,
                start_steps=30, start_total=35, max_steps=2**62, n_trace=16)
    for k, v in kw.items():
        setattr(c, k, v)
    next_scalars_plain(c)
    return c


def _masked(c) -> bytes:
    """The block's bytes without its pointers (device and host differ)."""
    c = c.copy()
    c.eps = c.t_tr = c.h_tr = None
    return bytes(c)


def _float_fields(c) -> np.ndarray:
    """The floating-point fields of a control block, as float64."""
    return np.array([c.t, c.h, c.h_cont, *c.hs, *c.ts64, *c.ts, c.h32, c.D1,
                     *c.dD])


def _max_abs_diff(a, b) -> float:
    """max |a - b| of two float arrays, a NaN or an inf on both sides at
    the same place counting as equal and on one side only as inf."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(a - b))
    return float(np.where(np.isnan(d), np.inf, d).max(initial=0.0))


def _check_control(dev, prm, wide=False) -> dict:
    """pft_merson_control against control_plain on every case: the block
    (every field but the pointers) and the trace bit for bit; also the
    largest difference of the block's float fields and the trace.
    ``wide``: the partials in float64 (the DEM's), with a case whose peak
    lies below delta and rounds to it in float32."""
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl

    bad, err = [], 0.0
    cases = _control_cases(prm)
    if wide:
        parts = cases[0][2].astype(np.float64)
        parts[int(np.argmax(parts))] = np.nextafter(1e-3, 0.0)
        cases = [(n, f, p.astype(np.float64)) for n, f, p in cases] + [
            ("rounds_to_delta", {}, parts)]
    for name, fields, parts in cases:
        c0 = _control_block(prm, **fields)
        c0.eps_f64 = int(wide)
        out = {}
        for where in ("kernel", "plain"):
            d = dev if where == "kernel" else torch.device("cpu")
            eps = torch.from_numpy(parts).to(d)
            block = ctl.ControlBlock(d, eps)
            block.t_tr, block.h_tr = (torch.full((c0.n_trace,), -1.0,
                                                 dtype=torch.float64,
                                                 device=d) for _ in range(2))
            c = c0.copy()
            c.eps, c.eps_n = eps.data_ptr(), eps.numel()
            c.t_tr, c.h_tr = block.t_tr.data_ptr(), block.h_tr.data_ptr()
            block.write(c)
            ctl.merson_control(block)
            r = block.read()
            tr = np.concatenate([block.t_tr.cpu().numpy(),
                                 block.h_tr.cpu().numpy()])
            out[where] = (_masked(r), tr.tobytes(), r,
                          np.concatenate([_float_fields(r), tr]))
        same = out["kernel"][:2] == out["plain"][:2]
        err = max(err, _max_abs_diff(out["kernel"][3], out["plain"][3]))
        r = out["kernel"][2]
        emit("control_case", case=name, eps_f64=r.eps_f64, bitwise=same,
             accept=r.accept,
             t=r.t, h=r.h, h_cont=r.h_cont, done=r.done, halt=r.halt,
             status=r.status, finished=r.finished, steps=r.steps,
             steps_total=r.steps_total, dD=list(r.dD))
        if not same:
            bad.append(name)
    if bad:
        raise AssertionError(f"pft_merson_control differs from its plain "
                             f"version (eps_f64 {int(wide)}): {bad}")
    return dict(cases=len(cases), bitwise=True, max_abs_err=err)


def _check_commit(dev) -> dict:
    """pft_commit against commit_plain at MR, each mode with the flag at 0
    and 1, bit for bit; also the largest difference of the outputs."""
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl

    rng = np.random.default_rng(SEED + 12)
    shape = (2,) + MR_SHAPE
    base = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev) for _ in range(3)]
    base[1] *= 1e-7
    results, err = {}, 0.0
    for mode in (ctl.COMMIT_COPY, ctl.COMMIT_TWOSUM, ctl.COMMIT_FLIP):
        for accept in (0, 1):
            got = {}
            for where in ("kernel", "plain"):
                d = dev if where == "kernel" else torch.device("cpu")
                block = ctl.ControlBlock(d, torch.zeros(1, device=d))
                block.write(ctl.Control(accept=accept))
                hi, lo, src = (x.clone() for x in base)
                cur = torch.zeros(1, dtype=torch.int32, device=dev)
                ctl.commit(block, mode, hi,
                           lo if mode == ctl.COMMIT_TWOSUM else None,
                           None if mode == ctl.COMMIT_FLIP else src, cur)
                got[where] = (hi, lo, cur)
            same = all(torch.equal(a, b) for a, b in zip(got["kernel"],
                                                         got["plain"]))
            for a, b in zip(got["kernel"], got["plain"]):
                err = max(err, float((a.double() - b.double()).abs().max()))
            changed = not all(torch.equal(a, b) for a, b in
                              zip(got["kernel"][:2], base[:2]))
            key = f"mode{mode}/accept{accept}"
            results[key] = same
            emit("commit_case", mode=mode, accept=accept, bitwise=same,
                 state_changed=changed or int(got["kernel"][2]) == 1)
    if not all(results.values()):
        raise AssertionError(f"pft_commit differs from its plain version: "
                             f"{results}")
    return dict(results, max_abs_err=err)


def _check_commit_f64(dev) -> dict:
    """pft_commit's copy of float64 planes against commit_plain, the flag
    at 0 and 1, bit for bit: the f64 freezing state of the LR golden
    (3, 100, 50, 50), the DEM's state at DEM_N and at the bench's 2000
    spheres (3 leaves of (n, 3)), and an odd count of elements."""
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl

    rng = np.random.default_rng(SEED + 15)
    results, err = {}, 0.0
    for shape in ((3,) + LR_SHAPE, (3, DEM_N, 3), (3, 2000, 3), (3, 67, 3)):
        base = [torch.from_numpy(rng.standard_normal(shape)).to(dev)
                for _ in range(2)]
        for accept in (0, 1):
            got = {}
            for where in ("kernel", "plain"):
                d = dev if where == "kernel" else torch.device("cpu")
                block = ctl.ControlBlock(d, torch.zeros(1, device=d))
                block.write(ctl.Control(accept=accept))
                hi = base[0].clone()
                ctl.commit(block, ctl.COMMIT_COPY, hi, src=base[1])
                got[where] = hi
            same = torch.equal(got["kernel"], got["plain"])
            err = max(err, float((got["kernel"] - got["plain"]).abs().max()))
            key = f"{'x'.join(map(str, shape))}/accept{accept}"
            results[key] = same
            emit("commit_case", mode=ctl.COMMIT_COPY, dtype="float64",
                 shape=list(shape), accept=accept, bitwise=same)
    if not all(results.values()):
        raise AssertionError(f"pft_commit's float64 copy differs from its "
                             f"plain version: {results}")
    return dict(results, max_abs_err=err)


def _check_dev_entries(dev, prm) -> dict:
    """The _dev entries against the by-value entries at MR, bit for bit:
    every stage variant of fused_stage, delta_g (and its dy tail) and
    fused_attempt, the scalars of the stage from a control block whose t
    lies on each side of the phase switch, calc modes 0/1/2; then a halted
    block, on which every _dev launch leaves its outputs as they were."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    w, ks = _inputs(MR_SHAPE, dev, np.random.default_rng(SEED + 13))
    h = 0.05
    n_cmp = 0
    for mode in (0, 1, 2):
        spec = st.StencilSpec.of(geom, prm, mode)
        slots = {k: st._eps_blocks(fn, dev, *a) for k, fn, a in (
            ("stage", "pft_stage_eps_blocks", (mode, 0) + MR_SHAPE),
            ("delta", "pft_delta_eps_blocks", (mode, 1) + MR_SHAPE),
            ("dy", "pft_delta_eps_blocks", (mode, 2) + MR_SHAPE),
            ("attempt", "pft_attempt_eps_blocks", (mode,) + MR_SHAPE))}
        for t in (prm.phase_switch_time - 0.5 * h,
                  prm.phase_switch_time + 1.0):
            c = _control_block(prm, t=t, h=h)
            block = ctl.ControlBlock(dev, torch.zeros(1, device=dev))
            block.write(c)
            pairs = []
            for q, (name, (cs, s5)) in enumerate(STAGE_CASES.items()):
                kk = list(zip(cs, ks))
                ref = st.fused_stage(spec, c.ts[q], c.h32, w, kk, stage5=s5)
                out = torch.empty_like(ks[0])
                eps = torch.empty(slots["stage"], device=dev)
                st.fused_stage_dev(spec, block, q, w, kk, out, stage5=s5,
                                   eps=eps if s5 else None)
                pairs.append((ref, (out, eps) if s5 else out))
            for q, (name, (cs, s5)) in enumerate(DELTA_CASES.items(), 1):
                for emit_ in (("y", "dy") if s5 else ("y",)):
                    kk = list(zip(cs, ks))
                    ref = st.delta_g(spec, c.h32, c.D1, c.dD[q], w, kk,
                                     stage5=s5, emit=emit_)
                    out = torch.empty_like(ks[0])
                    eps = torch.empty(slots["dy" if emit_ == "dy"
                                            else "delta"], device=dev)
                    st.delta_g_dev(spec, block, q, w, kk, out, stage5=s5,
                                   emit=emit_, eps=eps if s5 else None)
                    pairs.append((ref, (out, eps) if s5 else out))
            for q, (name, (cs, s5)) in enumerate(STAGE_CASES.items()):
                kk = list(zip(cs, ks))
                y2a = torch.stack([w, w]).contiguous()
                y2b = y2a.clone()
                cur = torch.ones(1, dtype=torch.int32, device=dev)
                ref = st.fused_attempt(spec, c.ts[q], c.h32, y2a, cur, kk,
                                       tail=s5)
                out = torch.empty_like(ks[0])
                eps = torch.empty(slots["attempt"], device=dev)
                st.fused_attempt_dev(spec, block, q, y2b, cur, kk, out,
                                     tail=s5, eps=eps)
                pairs.append(((y2a, ref), (y2b, eps)) if s5 else (ref, out))
            torch.cuda.synchronize()
            for ref, got in pairs:
                ref = ref if isinstance(ref, tuple) else (ref,)
                got = got if isinstance(got, tuple) else (got,)
                if not all(torch.equal(a, b) for a, b in zip(ref, got)):
                    raise AssertionError(
                        f"a _dev entry differs from its by-value entry "
                        f"(mode {mode}, t {t}, pair {n_cmp})")
                n_cmp += 1
    # a halted block: every _dev launch returns at once
    c = _control_block(prm, halt=1)
    block = ctl.ControlBlock(dev, torch.zeros(1, device=dev))
    block.write(c)
    spec = st.StencilSpec.of(geom, prm, 0)
    slots = {k: st._eps_blocks(fn, dev, *a) for k, fn, a in (
        ("delta", "pft_delta_eps_blocks", (0, 1) + MR_SHAPE),
        ("attempt", "pft_attempt_eps_blocks", (0,) + MR_SHAPE))}
    s5 = list(zip(DELTA_CASES["stage5"][0], ks))
    out = torch.full_like(ks[0], 7.0)
    eps = torch.full((slots["delta"],), 7.0, device=dev)
    st.fused_stage_dev(spec, block, 0, w, [], out)
    st.delta_g_dev(spec, block, 4, w, s5, out, stage5=True, eps=eps)
    y2 = torch.stack([w, w]).contiguous()
    cur = torch.zeros(1, dtype=torch.int32, device=dev)
    eps_a = torch.full((slots["attempt"],), 7.0, device=dev)
    st.fused_attempt_dev(spec, block, 4, y2, cur, s5, tail=True, eps=eps_a)
    torch.cuda.synchronize()
    idle = bool((out == 7.0).all() and (eps == 7.0).all()
                and (eps_a == 7.0).all() and torch.equal(y2[1], w))
    res = dict(pairs=n_cmp, bitwise=True, halted_untouched=idle)
    emit("dev_entries", **res)
    if not idle:
        raise AssertionError("a _dev launch on a halted block wrote")
    return res


def _pow_sweep(dev) -> dict:
    """The control kernel's pow_02 against the host's (solvers/merson.py)
    and against Python's ``**`` on 100000 q = delta/eps, log-uniform over
    [1e-3, 1e9]: mismatch counts."""
    from porousfreezethaw_tpu_torch.ops.cuda.control import pow_02_device
    from porousfreezethaw_tpu_torch.solvers.merson import pow_02

    q = 10.0 ** np.random.default_rng(SEED + 14).uniform(-3, 9, 100_000)
    got = pow_02_device(torch.from_numpy(q).to(dev)).cpu().numpy()
    host = np.array([pow_02(x) for x in q.tolist()])
    libm = q ** 0.2
    res = dict(n=len(q), vs_host_pow_02=int((got != host).sum()),
               vs_python_pow=int((got != libm).sum()))
    emit("pow_02_sweep", **res)
    if res["vs_host_pow_02"]:
        raise AssertionError(f"device pow_02 differs from the host's: {res}")
    return res


def _controller_rows(dev, prm, errs) -> dict:
    """The summary rows of pft_merson_control and pft_commit: times beside
    their bounds at MR (the control step on the MR DeltaAttempt's partial
    slots, at the eps whose growth factor is 1, so that h holds; the
    commit's copy of (u, p), accepted), and the largest error against the
    plain version that _check_control and _check_commit measured
    (``errs``, by kernel)."""
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    n_eps = st._eps_blocks("pft_delta_eps_blocks", dev, 0, 1, *MR_SHAPE)
    eps = torch.full((n_eps,), 1e-3 * 0.8 ** 5, device=dev)
    ctl_size = ctypes.sizeof(ctl.Control)
    c = _control_block(prm, n_trace=0)
    c.eps, c.eps_n = eps.data_ptr(), n_eps
    block = ctl.ControlBlock(dev, eps)
    block.write(c)
    hblock = ctl.ControlBlock(torch.device("cpu"), eps)
    hblock.write(c)
    shape = (2,) + MR_SHAPE
    # sets of (hi, lo, src) taken in turn, 192 MB in all, so that each
    # commit reads its planes from device memory and not from the L2
    sets = [tuple(torch.rand(shape, device=dev) for _ in range(3))
            for _ in range(COLD_SETS - 1)]
    turn = itertools.cycle(sets)
    cblock = ctl.ControlBlock(dev, eps)
    cblock.write(ctl.Control(accept=1))
    pblock = ctl.ControlBlock(torch.device("cpu"), eps)
    pblock.write(ctl.Control(accept=1))
    times = {}
    for impl in ("plain", "kernel", "kernel_device", "kernel2", "plain2"):
        timer = _queued_ms if impl == "kernel_device" else _time
        plain = impl.startswith("plain")
        b, bc = (hblock, pblock) if plain else (block, cblock)
        def copy():
            hi, _, src = next(turn)
            ctl.commit(bc, ctl.COMMIT_COPY, hi, src=src)

        def twosum():
            hi, lo, src = next(turn)
            ctl.commit(bc, ctl.COMMIT_TWOSUM, hi, lo, src=src)

        times[impl] = dict(control=timer(lambda: ctl.merson_control(b), 50),
                           commit=timer(copy, 48),
                           commit_twosum=timer(twosum, 48))

    def library_copy():
        hi, _, src = next(turn)
        hi.copy_(src)

    copy_ms = _time(library_copy, 48)
    # copy_'s device time, to set beside the commit's device_ms: inside a
    # graph only the device time of a launch counts
    copy_device_ms = _queued_ms(library_copy, 48)
    emit("controller_kernel_times", shape=list(shape), eps_slots=n_eps,
         ms=times, library_copy_ms=copy_ms,
         library_copy_device_ms=copy_device_ms)

    def avg(key, *impls):
        return float(np.mean([times[i][key] for i in impls]))

    out = {}
    plane_bytes = 4 * int(np.prod(shape))
    for name, key, nbytes, ops, library, src_name, what in (
            ("merson_control", "control", 4 * n_eps + 2 * ctl_size,
             CONTROL_OPS, None, "control.cu",
             f"one step on {n_eps} eps partials (MR DeltaAttempt)"),
            ("commit", "commit", 2 * plane_bytes, 0, copy_ms, "control.cu",
             "the accepted copy of (u, p) at MR, its planes cold in L2; "
             "library_ms: one Tensor.copy_, library_device_ms its "
             "device time")):
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       ops / F64_FLOP_PER_S) * 1e3
        out[name] = dict(
            name=name, route="cuda",
            source=f"porousfreezethaw_tpu_torch/csrc/{src_name}",
            replaces=("porousfreezethaw_tpu/solvers/merson.py:239"
                      if name == "merson_control" else
                      "porousfreezethaw_tpu/solvers/merson.py:283"),
            replaces_what=("the body of the lax.while_loop controller "
                           "(XLA, no Pallas kernel)" if name ==
                           "merson_control" else
                           "the accepted-update select of the while-loop "
                           "body (XLA, no Pallas kernel)"),
            launches=0, max_abs_err=errs[name],
            ms=avg(key, "kernel", "kernel2"),
            plain_ms=avg(key, "plain", "plain2"),
            bound_ms=bound_ms, bound_by="bytes", library_ms=library,
            device_ms=avg(key, "kernel_device"),
            bound_share=bound_ms / avg(key, "kernel_device"),
            timed=what + TIMED_BY)
    out["commit"]["twosum_device_ms"] = avg("commit_twosum", "kernel_device")
    out["commit"]["library_device_ms"] = copy_device_ms
    return out


def _controller_rows_f64(dev, prm, errs) -> dict:
    """The summary rows of the float64 variants of pft_merson_control and
    pft_commit at the shapes of their main paths: the f64 LR Temp golden
    (PlainAttempt: the control step on its one float64 partial, the
    commit's copy of the (3, 100, 50, 50) state, 6 MB, its planes cold in
    L2) and, for ``commit_f64_dem``, the DEM's short solve
    (friction_angular, DEM_N spheres: the copy of the (3, DEM_N, 3)
    state); the copies accepted; times beside their bounds and the largest
    error against the plain versions (``errs``, by row)."""
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl

    eps = torch.full((1,), 1e-3 * 0.8 ** 5, dtype=torch.float64, device=dev)
    c = _control_block(prm, n_trace=0)
    c.eps, c.eps_n, c.eps_f64 = eps.data_ptr(), 1, 1
    blocks = {}
    for where, d in (("kernel", dev), ("plain", torch.device("cpu"))):
        blocks[where] = ctl.ControlBlock(d, eps)
        blocks[where].write(c)
        blocks["commit_" + where] = ctl.ControlBlock(d, eps)
        blocks["commit_" + where].write(ctl.Control(accept=1))
    lr, dem = (3,) + LR_SHAPE, (3, DEM_N, 3)
    # pairs of (hi, src) taken in turn, 192 MB in all at LR, so that each
    # copy reads its planes from device memory and not from the L2
    pairs = {shape: [tuple(torch.rand(shape, dtype=torch.float64,
                                      device=dev) for _ in range(2))
                     for _ in range(16 if shape == lr else 1)]
             for shape in (lr, dem)}
    turns = {shape: itertools.cycle(p) for shape, p in pairs.items()}
    times = {}
    for impl in ("plain", "kernel", "kernel_device", "kernel2", "plain2"):
        timer = _queued_ms if impl == "kernel_device" else _time
        where = "plain" if impl.startswith("plain") else "kernel"
        b, bc = blocks[where], blocks["commit_" + where]

        def copy(shape):
            hi, src = next(turns[shape])
            ctl.commit(bc, ctl.COMMIT_COPY, hi, src=src)

        times[impl] = dict(control=timer(lambda: ctl.merson_control(b), 50),
                           commit=timer(lambda: copy(lr), 48),
                           commit_dem=timer(lambda: copy(dem), 50))

    def library_copy(shape):
        hi, src = next(turns[shape])
        hi.copy_(src)

    copy_ms = {shape: _time(lambda: library_copy(shape), 48)
               for shape in (lr, dem)}
    copy_device_ms = {shape: _queued_ms(lambda: library_copy(shape), 48)
                      for shape in (lr, dem)}
    emit("controller_kernel_times", dtype="float64", shapes=[lr, dem],
         eps_slots=1, ms=times,
         library_copy_ms={str(k): v for k, v in copy_ms.items()},
         library_copy_device_ms={str(k): v
                                 for k, v in copy_device_ms.items()})

    def avg(key, *impls):
        return float(np.mean([times[i][key] for i in impls]))

    out = {}
    for name, key, shape, ops, library, what in (
            ("merson_control_f64", "control", None, CONTROL_OPS, None,
             "one step on the f64 LR golden's one float64 partial"),
            ("commit_f64", "commit", lr, 0, copy_ms[lr],
             f"the accepted copy of the f64 LR golden's state {lr}, its "
             f"planes cold in L2; library_ms: one Tensor.copy_, "
             f"library_device_ms its device time"),
            ("commit_f64_dem", "commit_dem", dem, 0, copy_ms[dem],
             f"the accepted copy of the float64 DEM state {dem}; "
             f"library_ms: one Tensor.copy_, library_device_ms its "
             f"device time")):
        nbytes = (8 + 2 * ctypes.sizeof(ctl.Control) if shape is None
                  else 2 * 8 * int(np.prod(shape)))
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       ops / F64_FLOP_PER_S) * 1e3
        out[name] = dict(
            name=name, route="cuda",
            source="porousfreezethaw_tpu_torch/csrc/control.cu",
            replaces=("porousfreezethaw_tpu/solvers/merson.py:239"
                      if key == "control" else
                      "porousfreezethaw_tpu/solvers/merson.py:283"),
            replaces_what=(
                "the body of the lax.while_loop controller on a float64 "
                "state (XLA, no Pallas kernel)" if key == "control" else
                "the accepted-update select of the while-loop body on "
                + ("the f64 freezing state" if shape == lr
                   else "the DEM's float64 leaves")
                + " (XLA, no Pallas kernel)"),
            launches=0, max_abs_err=errs[name],
            ms=avg(key, "kernel", "kernel2"),
            plain_ms=avg(key, "plain", "plain2"),
            bound_ms=bound_ms,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops
            / F64_FLOP_PER_S else "operations",
            library_ms=library, device_ms=avg(key, "kernel_device"),
            bound_share=bound_ms / avg(key, "kernel_device"),
            timed=what + TIMED_BY)
        if shape is not None:
            out[name]["library_device_ms"] = copy_device_ms[shape]
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
# phase controller: the device-resident loop against the host loop
# --------------------------------------------------------------------------

CONTROLLER_GRIDS = (200, 100)        # MR, LR
CONTROLLER_PATHS = ("delta", "delta_comp", "fused_attempt", "stage")
CONTROLLER_WARM = 40
CONTROLLER_REPEATS = 3


class _EpsTap:
    """An attempt_fn that records each attempt's eps (a sync each: used
    only in an untimed run)."""

    def __init__(self, inner):
        self.inner, self.eps = inner, []

    def pack(self, y):
        return self.inner.pack(y)

    def attempt(self, t, h, y):
        carry, e = self.inner.attempt(t, h, y)
        self.eps.append(float(torch.amax(e)))
        return carry, e

    def commit(self, carry, accept):
        return self.inner.commit(carry, accept)

    def unpack(self, y):
        return self.inner.unpack(y)


def _loop_solvers(path, geom, prm):
    """(host-loop solve, device-loop solve, the device loop's object) of
    one path; each solve is ``(state, params) -> merson_solve's result``
    to t = 1e9."""
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.solvers.merson import (
        merson_solve, merson_solve_device)

    if path == "stage":
        stage_fn = st.make_fused_stage(geom, prm, 0)
        dev_att = st.StageAttempt(geom, prm, 0)

        def host(s, p):
            return merson_solve(None, s, 1e9, p, stage_fn=stage_fn)
    else:
        cls = {"delta": st.DeltaAttempt, "delta_comp": st.DeltaAttemptComp,
               "fused_attempt": st.FusedAttempt}[path]
        host_att, dev_att = cls(geom, prm, 0), cls(geom, prm, 0)

        def host(s, p):
            return merson_solve(None, s, 1e9, p, attempt_fn=host_att)

    def device(s, p):
        return merson_solve_device(s, 1e9, p, dev_att)

    return host, device, dev_att


def _same_state(a, b) -> bool:
    """Status, t, h, counts and state of two solves bit for bit."""
    sa, sb = a[0], b[0]
    return (a[1] == b[1] and (sa.t, sa.h, sa.steps, sa.steps_total)
            == (sb.t, sb.h, sb.steps, sb.steps_total)
            and torch.equal(sa.y, sb.y))


def _same_result(a, b) -> bool:
    return (_same_state(a, b)
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


# how far the f64 path's device loop (the float64 stage kernel) may part
# from its host loop on the card (the plain right-hand side): the state
# within LOOP_GAP_STATE of max|y|, the bound of the card test
# tests/test_torch_cuda.py test_plain_device_loop_equals_host_loop; t, h
# and the trace within LOOP_GAP_STEP, relative.  That test holds t, h and
# the trace to 1e-10 against a host loop that rounds as the kernel does
# (the CPU's, for the phase-field models).  The card's PyTorch kernels
# divide by the scalar alpha as a product with its reciprocal, an ulp
# apart, and the error estimate, a difference of nearly equal stages,
# carries that into h: on an H100 over 96 attempts h parted by 1.6e-7 at
# MR GradP, 4.1e-9 at LR GradP and 0 at LR Temp, the state by 6.0e-11,
# 2.8e-12 and 0, with equal counts
LOOP_GAP_STATE = 1e-10
LOOP_GAP_STEP = 1e-6


def _loop_gap(a, b) -> dict:
    """How two solves of one start by two loops (the f64 path's stage
    kernel and its plain right-hand side) part: counts, status, t and h
    (relative), the record_trace arrays (the largest relative gap) and the
    state (of max|y|); ``close``: the same counts and status, t, h and the
    trace within LOOP_GAP_STEP and the state within LOOP_GAP_STATE."""
    sa, sb = a[0], b[0]
    trace = max(((float(torch.where(x == y, 0.0, (x - y).abs() / y.abs())
                        .max()) if x.numel() and x.shape == y.shape
                  else 0.0 if x.shape == y.shape else float("inf"))
                 for x, y in zip(a[2], b[2])), default=0.0)
    gap = dict(counts=[(sa.steps, sa.steps_total),
                       (sb.steps, sb.steps_total)],
               status=[a[1], b[1]],
               t_rel=abs(sa.t - sb.t) / max(abs(sb.t), 1e-300),
               h_rel=abs(sa.h - sb.h) / max(abs(sb.h), 1e-300),
               trace_rel=trace,
               state=float((sa.y - sb.y).abs().max() / sb.y.abs().max()))
    gap["close"] = (gap["counts"][0] == gap["counts"][1]
                    and a[1] == b[1] and len(a[2]) == len(b[2])
                    and max(gap["t_rel"], gap["h_rel"],
                            gap["trace_rel"]) <= LOOP_GAP_STEP
                    and gap["state"] <= LOOP_GAP_STATE)
    return gap


# the launches of one attempt by counter, on each path; the device loop
# adds one merson_control and one commit
PER_ATTEMPT = {"delta": {"fused_stage": 1, "delta_g": 4},
               "delta_comp": {"fused_stage": 1, "delta_g": 3,
                              "delta_g_dy": 1},
               "fused_attempt": {"fused_attempt": 5},
               "stage": {"fused_stage": 5}}
DEVICE_LOOP = {"merson_control": 1, "commit": 1}

# the counter of each kernel, by the name of its __global__ function
KERNEL_COUNTERS = (("fused_stage_kernel", ("fused_stage", "fused_stage_shard",
                                           "fused_stage_split")),
                   ("delta_g_kernel", ("delta_g", "delta_g_dy",
                                       "delta_g_shard", "delta_g_shard_dy")),
                   ("fused_attempt_kernel", ("fused_attempt",)),
                   ("merson_control_kernel", ("merson_control",
                                              "merson_control_f64")),
                   ("commit_kernel", ("commit", "commit_f64")))


def _want_launches(path, n, device_loop=False):
    """The launches of ``n`` attempt launches on ``path``, by counter."""
    per = dict(PER_ATTEMPT[path], **(DEVICE_LOOP if device_loop else {}))
    return {k: v * n for k, v in per.items()}


def _want_f64(n) -> dict:
    """The launches of ``n`` attempt launches of the f64 path's device
    loop (PlainAttempt's float64 stage-kernel route), by counter: five
    fused_stage launches, the float64 control and commit."""
    return {"fused_stage": 5 * n, "merson_control_f64": n,
            "commit_f64": n}


def _graph_attempts(calls, captures=0) -> int:
    """The attempts the device loop launches for solve calls of ``calls``
    attempts each: whole blocks of BLOCK, plus one idle attempt before
    each of ``captures`` graph captures."""
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK
    return captures + sum(BLOCK * -(-n // BLOCK) for n in calls)


def _path_attempts(launches, path, device_loop) -> int:
    """The attempt launches that ``launches`` (by counter) hold on
    ``path``: one number for every kernel of the path, else an error."""
    return _attempts_of(launches, dict(
        PER_ATTEMPT[path], **(DEVICE_LOOP if device_loop else {})), path)


def _attempts_of(launches, per, what) -> int:
    """The attempt launches that ``launches`` (by counter) hold of an
    attempt of ``per`` launches by counter: one number for every counter
    of ``per``, and no launch of another, else an error."""
    ms = {launches.get(k, 0) / v for k, v in per.items()}
    others = {k: c for k, c in launches.items() if c and k not in per}
    if len(ms) != 1 or others or not float(next(iter(ms))).is_integer():
        raise AssertionError(f"{what}: launches {launches} are not whole "
                             f"attempts of {per}")
    return int(ms.pop())


def _profiled_launches(prof) -> dict:
    """The launches of each of the port's kernels in a torch.profiler
    trace, by kernel name (KERNEL_COUNTERS)."""
    got = {name: 0 for name, _ in KERNEL_COUNTERS}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, _ in KERNEL_COUNTERS:
            if name in e.key:
                got[name] += e.count
    return got


# profiled runs of one solve before a trace that lost kernel records fails
PROFILE_TRIES = 3

# the one-element fills that the profiler records and drops before a
# profiled run (_profiled)
PROFILE_WARM_KERNELS = 64


def _profiled(run):
    """``run()`` under torch.profiler (CPU and CUDA activity), after a
    warm-up step in which the profiler records PROFILE_WARM_KERNELS
    one-element fills and drops them.  A session's first kernel records
    can be lost: on an H100, profiled device-loop runs of phase
    controller's f64 rows without this step lost 1-6 records among the
    run's first six kernels in every trace of a row but the process's
    first, one fill before the run lowered the loss by one, and with the
    fills no trace of the rows lost a record (9 of 9).  Returns (the
    profiler, the run's result)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(1, device=torch.cuda.current_device())
        for _ in range(PROFILE_WARM_KERNELS):
            x.fill_(0.0)
        torch.cuda.synchronize()
        prof.step()
        res = run()
        torch.cuda.synchronize()
    return prof, res


def _traced_run(st, run, same, what):
    """``run()`` profiled (_profiled) with the counters at 0: each of the
    port's kernels launched in the trace as many times as its counter
    added (KERNEL_COUNTERS), and ``same(res)`` true of the run's result
    ``res``.  A trace that still holds fewer launches than counted, of a
    run whose result is bit for bit right, is profiled again, up to
    PROFILE_TRIES runs in all.  A wrong result, a trace with more launches
    than counted, or no trace that agrees raises.  When the profiler
    records no device time, the launches are not checked.  Returns (the
    profiler, the traced launches, the traces that lost records)."""
    lost = []
    for _ in range(PROFILE_TRIES):
        _reset_all(st)
        torch.cuda.synchronize()
        prof, res = _profiled(run)
        counted = _all_counters(st)
        if not same(res):
            raise AssertionError(f"{what}: the profiled run's result "
                                 f"differs")
        got = _profiled_launches(prof)
        want = {name: sum(counted[k] for k in keys)
                for name, keys in KERNEL_COUNTERS}
        if not _device_time(prof)[0] or got == want:
            return prof, got, lost
        if any(got[k] > want[k] for k in want):
            raise AssertionError(f"{what}: traced launches {got}, counted "
                                 f"{want}")
        lost.append(got)
    raise AssertionError(f"{what}: traced launches {lost}, counted {want} "
                         f"in each of {PROFILE_TRIES} profiled runs")


def _idle_block_ms(dev_att, dev) -> float:
    """Device ms of one replay of the graph of BLOCK attempts on a halted
    block: the cost of the idle attempts at the end of a solve call."""
    loop = dev_att.device_loop(dev)
    graph, _ = loop._graph()
    c = loop.ctl.read()
    c.halt = 1
    loop.ctl.write(c)
    return _time(graph.replay, 20)


# the f64 rows of phase controller: (name, grid nodes, calc mode) of the
# benchmark case (bench.freezing_case), PlainAttempt against the host loop
CONTROLLER_F64 = (("lr_temp", 100, 2), ("lr_gradp", 100, 0),
                  ("mr_gradp", 200, 0))
CONTROLLER_F64_ATTEMPTS = 96     # three whole blocks: no idle attempts
CONTROLLER_F64_WARM = 32
CONTROLLER_F64_PROFILED = 32     # the profiled runs: one whole block


def _kernel_classes(rows) -> dict:
    """Launches and device us of a profiler's kernel rows by class: the
    port's control and commit kernels, PyTorch's cat, reductions,
    elementwise kernels and the rest."""
    out = {c: {"launches": 0, "us": 0.0} for c in (
        "control_commit", "cat", "reduction", "elementwise", "other")}
    for us, key, count in rows:
        k = key.lower()
        cls = ("control_commit" if "merson_control_kernel" in k
               or "commit_kernel" in k else
               "cat" if "cat" in k else
               "reduction" if "reduce" in k else
               "elementwise" if "elementwise" in k else "other")
        out[cls]["launches"] += count
        out[cls]["us"] += us
    total = sum(c["us"] for c in out.values()) or 1.0
    for c in out.values():
        c["share"] = c["us"] / total
    return out


def _controller_f64_rows(dev) -> list:
    """The f64 path (the f64 app's, PlainAttempt: on the device loop its
    float64 stage kernel, on the host loop the plain right-hand side) at
    LR Temp, LR GradP and MR GradP: CONTROLLER_F64_WARM host-loop attempts
    from the benchmark case, then CONTROLLER_F64_ATTEMPTS attempts through
    the device loop (its first run captures the graph) and the host loop,
    CONTROLLER_REPEATS times each in turns, every run bit for bit its
    loop's first (state, t, h, counts, status, trace); the two loops held
    together (``loop_gap``: the same counts and status, and t, h, the
    trace and the state within LOOP_GAP_STEP and LOOP_GAP_STATE);
    ms/attempt (median and
    spread), device ms and launches per attempt, busy share and the
    kernel classes' shares (torch.profiler over one more run of each, of
    CONTROLLER_F64_PROFILED attempts, held to the device loop's), the
    right-hand side's launches (five profiled calls, t a 0-d tensor), the
    graph's capture time, the memory peak over the capturing run above
    what was allocated before it (the static buffers and the graph's
    pool), and the cost of an idle attempt (an idle block's replay over
    BLOCK)."""
    from torch.profiler import ProfilerActivity, profile

    from porousfreezethaw_tpu_torch import bench
    from porousfreezethaw_tpu_torch.models.freezing.attempt import (
        PlainAttempt)
    from porousfreezethaw_tpu_torch.models.freezing.equation import make_rhs
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve, merson_solve_device)

    n = CONTROLLER_F64_ATTEMPTS
    rows = []
    for name, grid_nodes, mode in CONTROLLER_F64:
        v, geom, prm, w0 = bench.freezing_case(grid_nodes, mode,
                                               torch.float64)
        rhs = make_rhs(geom, prm, mode, dev)
        att = PlainAttempt(rhs, geom.shape, torch.float64)

        def params(max_steps, trace=0):
            return MersonParams(delta=v["delta"], h_min=v["tau_min"],
                                max_steps=max_steps, record_trace=trace)

        def host(s, p):
            return merson_solve(rhs, s, 1e9, p)

        def device(s, p):
            return merson_solve_device(s, 1e9, p, att)

        y0 = torch.from_numpy(w0).to(dev)
        start = host(merson_init(y0, 0.0, min(v["tau"], 1e-4)),
                     params(CONTROLLER_F64_WARM))[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        refs = {"device": device(start, params(n, n))}   # captures
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        refs["host"] = host(start, params(n, n))
        ref = refs["device"]
        gap = _loop_gap(ref, refs["host"])
        walls = {"host": [], "device": []}
        for loop in ("host", "device", "device", "host") * 2:
            if len(walls[loop]) == CONTROLLER_REPEATS:
                continue
            _reset_counters(st)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = (host if loop == "host" else device)(start, params(n, n))
            torch.cuda.synchronize()
            walls[loop].append(1e3 * (time.perf_counter() - t0) / n)
            launches = {k: c for k, c in _counters(st).items() if c}
            want = {} if loop == "host" else _want_f64(n)
            if not _same_result(res, refs[loop]):
                raise AssertionError(f"controller f64 {name}: the {loop} "
                                     f"loop differs from its first run")
            if launches != want:
                raise AssertionError(f"controller f64 {name}: {loop} loop "
                                     f"launches {launches}, want {want}")
        n_prof = CONTROLLER_F64_PROFILED
        prof, lost = {}, {}
        for loop in ("host", "device"):
            fn = host if loop == "host" else device
            ref_prof = fn(start, params(n_prof))
            p, _, lost[loop] = _traced_run(
                st, lambda fn=fn: fn(start, params(n_prof)),
                lambda res, r=ref_prof: _same_state(res, r),
                f"controller f64 {name}, {loop} loop")
            prof[loop] = _device_time(p)
        t_dev = torch.tensor(start.t, dtype=torch.float64, device=dev)
        rhs(t_dev, start.y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(5):
                rhs(t_dev, start.y)
            torch.cuda.synchronize()
        rhs_us, rhs_kernels, _ = _device_time(p)
        idle_ms = _idle_block_ms(att, dev) / BLOCK
        row = dict(grid=list(geom.shape), case=name, calc_mode=mode,
                   dtype="f64", attempts=n, profiled_attempts=n_prof,
                   steps=ref[0].steps - start.steps, t=ref[0].t,
                   h=ref[0].h, status=ref[1], loop_gap=gap, block=BLOCK,
                   graph_capture_s=att.device_loop(dev).capture_s,
                   capture_run_peak_mb=peak_mb,
                   rhs_launches=(rhs_kernels / 5 if rhs_us
                                 else "not measured"),
                   rhs_device_ms=(rhs_us / 1e3 / 5 if rhs_us
                                  else "not measured"),
                   idle_attempt_ms=idle_ms, traces_lost=lost)
        for loop in ("host", "device"):
            w = sorted(walls[loop])
            us, kernels, krows = prof[loop]
            med = float(np.median(w))
            dms = us / 1e3 / n_prof if us else "not measured"
            row[loop] = dict(
                ms_per_attempt=med, repeats=w, spread=w[-1] / w[0],
                device_ms_per_attempt=dms,
                launches_per_attempt=kernels / n_prof if us else None,
                busy_share=dms / med if us else "not measured",
                classes=_kernel_classes(krows) if us else None,
                top=[dict(kernel=k[:60], count=c, us=u)
                     for u, k, c in krows[:6]])
        row["speedup"] = (row["host"]["ms_per_attempt"]
                          / row["device"]["ms_per_attempt"])
        emit("controller_f64", **row)
        if not gap["close"]:
            raise AssertionError(f"controller f64 {name}: the device loop "
                                 f"parts from the host loop: {gap}")
        rows.append(row)
    return rows


def phase_controller(dev) -> dict:
    """MR and LR GradP f32: for DeltaAttempt, DeltaAttemptComp,
    FusedAttempt and the classic stage path, CONTROLLER_WARM attempts of
    the host loop, then SOLVE_ATTEMPTS attempts from there through the
    device loop (merson_solve_device) and the host loop (merson_solve),
    CONTROLLER_REPEATS times each in turns: status, counts, t, h, the
    record_trace arrays and the state bit for bit equal, every repeat
    alike; ms/attempt (median and spread), device ms/attempt
    (torch.profiler over one more run of each) and the busy share; the
    device loop's launches; the idle-block cost of BLOCK; and the control
    kernel's growth power against Python's ``**`` and the host's pow_02 on
    the eps values of the runs, with the host's time per call of each.

    Launches: the host loop's are its attempts times the path's launches
    per attempt; the device loop's are whole blocks of BLOCK attempts
    (the graph launches the idle attempts after the loop halts too).  In
    the profiled run of each loop, the launches of each kernel in the
    profiler's trace equal what its counter added (_traced_run)."""
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.ops.cuda.control import (
        BLOCK, pow_02_device)
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve, pow_02)

    n = SOLVE_ATTEMPTS
    rows, eps_seen = [], []
    for grid_nodes in CONTROLLER_GRIDS:
        geom, prm, v, y0, h0 = _mr_state(dev, grid_nodes)
        for path in CONTROLLER_PATHS:
            def params(max_steps, trace=0):
                return MersonParams(
                    delta=v["delta"], h_min=v["tau_min"], handle_nan=True,
                    max_steps=max_steps, record_trace=trace,
                    accept_growth_min=1.05 if path == "stage" else 0.0)

            host, device, dev_att = _loop_solvers(path, geom, prm)
            start = host(merson_init(y0, 0.0, h0),
                         params(CONTROLLER_WARM))[0]
            if path != "stage":
                tap = _EpsTap(type(dev_att)(geom, prm, 0))
                merson_solve(None, start, 1e9, params(n), attempt_fn=tap)
                eps_seen += tap.eps
            ref = device(start, params(n, n))     # captures the graph
            torch.cuda.synchronize()
            walls = {"host": [], "device": []}
            for loop in ("host", "device", "device", "host") * 2:
                if len(walls[loop]) == CONTROLLER_REPEATS:
                    continue
                _reset_counters(st)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = (host if loop == "host" else device)(start,
                                                           params(n, n))
                torch.cuda.synchronize()
                walls[loop].append(1e3 * (time.perf_counter() - t0) / n)
                launches = {k: c for k, c in _counters(st).items() if c}
                want = (_want_launches(path, n) if loop == "host" else
                        _want_launches(path, _graph_attempts([n]), True))
                if not _same_result(res, ref):
                    raise AssertionError(
                        f"controller {path} at {grid_nodes}: the {loop} "
                        f"loop differs from the device loop's first run")
                if launches != want:
                    raise AssertionError(
                        f"controller {path} at {grid_nodes}: {loop} loop "
                        f"launches {launches}, want {want}")
            device_ms, traced, lost = {}, {}, {}
            for loop in ("host", "device"):
                # each kernel's launches in the trace against its counter's
                prof, traced[loop], lost[loop] = _traced_run(
                    st, lambda: (host if loop == "host" else device)(
                        start, params(n)),
                    lambda res: _same_state(res, ref),
                    f"controller {path} at {grid_nodes}, {loop} loop")
                us, kernels, _ = _device_time(prof)
                device_ms[loop] = (us / 1e3 / n if us else "not measured",
                                   kernels / n if us else None)
            idle_ms = _idle_block_ms(dev_att, dev)
            row = dict(grid=list(geom.shape), path=path, attempts=n,
                       steps=ref[0].steps - start.steps, t=ref[0].t,
                       h=ref[0].h, status=ref[1], bitwise=True,
                       block=BLOCK, idle_block_ms=idle_ms,
                       idle_attempt_ms=idle_ms / BLOCK,
                       traced_launches=traced, traces_lost=lost)
            for loop in ("host", "device"):
                w = sorted(walls[loop])
                dms, kern = device_ms[loop]
                med = float(np.median(w))
                row[loop] = dict(
                    ms_per_attempt=med, repeats=w,
                    spread=w[-1] / w[0],
                    device_ms_per_attempt=dms,
                    kernels_per_attempt=kern,
                    busy_share=(dms / med if isinstance(dms, float)
                                else "not measured"))
            row["speedup"] = (row["host"]["ms_per_attempt"]
                              / row["device"]["ms_per_attempt"])
            emit("controller", **row)
            rows.append(row)
    # the growth power on the runs' eps values
    delta = float(v["delta"])
    q = np.array([delta / e for e in eps_seen if 0.0 < e < float("inf")])
    got = pow_02_device(torch.from_numpy(q).to(dev)).cpu().numpy()
    qs = q.tolist()
    host_us = {}
    for name, fn in (("pow_02", pow_02), ("python_pow", lambda x: x ** 0.2)):
        t0 = time.perf_counter()
        for x in qs:
            fn(x)
        host_us[name] = 1e6 * (time.perf_counter() - t0) / max(len(qs), 1)
    host_ms = [r["host"]["ms_per_attempt"] for r in rows]
    fac = dict(n=len(q),
               vs_python_pow=int((got != q ** 0.2).sum()),
               vs_host_pow_02=int((got != np.array(
                   [pow_02(x) for x in qs])).sum()),
               host_us_per_call=host_us,
               # the host loop calls pow_02 once per attempt
               share_of_host_loop_attempt=[
                   1e-3 * host_us["pow_02"] / ms for ms in host_ms])
    emit("controller_fac", **fac)
    if fac["vs_host_pow_02"]:
        raise AssertionError(f"the device's growth power differs from the "
                             f"host loop's: {fac}")
    return dict(rows=rows, fac=fac, f64=_controller_f64_rows(dev))


# --------------------------------------------------------------------------
# phase 5: the port's bench
# --------------------------------------------------------------------------

# (--fused, --dtype, --grid-nodes, --steps, --warm-steps)
BENCH_ROWS = (("stage", "f32", 200, 200, 200), ("delta", "f32", 200, 200, 200),
              ("attempt", "f32", 200, 200, 200), ("off", "f64", 100, 64, 64))


def _counters(st) -> dict:
    from porousfreezethaw_tpu_torch.ops.cuda import control
    return {"fused_stage": st.fused_stage.launches,
            "delta_g": st.delta_g.launches,
            "delta_g_dy": st.delta_g.launches_dy,
            "fused_attempt": st.fused_attempt.launches,
            "merson_control": control.merson_control.launches,
            "commit": control.commit.launches,
            "merson_control_f64": control.merson_control.launches_f64,
            "commit_f64": control.commit.launches_f64}


def _reset_counters(st) -> None:
    from porousfreezethaw_tpu_torch.ops.cuda import control
    st.fused_stage.launches = st.delta_g.launches = 0
    st.delta_g.launches_dy = st.fused_attempt.launches = 0
    control.merson_control.launches = control.commit.launches = 0
    control.merson_control.launches_f64 = control.commit.launches_f64 = 0


def phase_bench(dev) -> dict:
    """The port's bench rows in this process, each record under bench.py's
    metric names with the launch counters of its run, every row through
    the device loop (the f64 --fused off row through PlainAttempt, on its
    float64 stage-kernel route: _want_f64); returns the counters of the
    --fused attempt row, the main path of K4."""
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
        # the bench's solve calls, each of --steps attempts: the warm-up's,
        # then the timed one; the device loop launches whole blocks of
        # BLOCK attempts, plus one idle attempt before its one capture
        calls = [steps] * (max(1, -(-warm // steps)) + 1)
        if rec["attempts"] + rec["warm_attempts"] != sum(calls):
            raise AssertionError(f"bench row {fused}/{dtype}: {rec}")
        path = {"stage": "stage", "delta": "delta",
                "attempt": "fused_attempt"}.get(fused)
        graph = _graph_attempts(calls, 1)
        want = (_want_f64(graph) if path is None
                else _want_launches(path, graph, True))
        want = {k: want.get(k, 0) for k in launches}
        if rec["controller"] != "device" or not rec["graph_capture_s"] > 0:
            raise AssertionError(f"bench row {fused}/{dtype}: controller "
                                 f"{rec['controller']}, capture "
                                 f"{rec['graph_capture_s']}")
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
        device_us, _, rows = _device_time(prof)
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

RK_STEP = re.compile(r"step (\d+), t=\s*(\S+), tau=\s*(\S+), .*"
                     r"Est\. time to snapshot (\d+) \(t=\s*(\S+)\)")


def _app_run(dev, golden: str, precision: str, extra: str = "",
             controller: str = "auto") -> dict:
    """The intertrack app on ``tests/golden/<golden>`` to snapshot 1 with
    its RK debug log, with the launch counters set to 0 just before it and
    read just after; ``rk`` holds the debug log's (step, t, tau, snapshot,
    snapshot t) of each accepted step.  ``controller`` "host" runs the
    host loop on every path (the app's ``uses_device_loop`` patched),
    "auto" the app's own choice."""
    from porousfreezethaw_tpu_torch.apps import intertrack
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
        rk_path = os.path.join(out, "rk.log")
        with open(pfile, "w") as f:
            f.write(text + f"\nset debug_logfile = {rk_path}\n")
        os.environ["OUTPUT"] = out
        own = intertrack.uses_device_loop
        if controller == "host":
            intertrack.uses_device_loop = lambda device, mesh: False
        _reset_counters(st)
        t0 = time.perf_counter()
        try:
            rc = main([pfile, "--precision", precision, "--device",
                       str(dev)])
        finally:
            intertrack.uses_device_loop = own
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counters(st)
        log = open(os.path.join(out, "intertrack.log")).read()
        rk = [RK_STEP.search(ln).groups() for ln in open(rk_path)
              if ln.strip()]
        files = sorted(f for f in os.listdir(out) if f.endswith(".ncd"))
        snap = (open(os.path.join(out, "image.001.ncd"), "rb").read()
                if "image.001.ncd" in files else None)
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
        shutil.rmtree(out, ignore_errors=True)
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    solver_s = _wall_s(log, "Solver")
    res = dict(golden=golden, precision=precision, extra=extra.strip(),
               controller=controller, rc=rc, files=files,
               launches=launches, wall_s=wall,
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
    res["snapshot"] = snap
    res["rk"] = rk
    return res


def _within(res, steps, attempts) -> None:
    if (abs(res["steps"] - steps) > 0.05 * steps
            or abs(res["attempts"] - attempts) > 0.05 * attempts):
        raise AssertionError(
            f"{res['golden']} {res['extra']}: steps "
            f"{res['steps']}/{res['attempts']} not within 5% of "
            f"{steps}/{attempts}")


def _app_profile(dev) -> None:
    """The app with --profile-dir on the 12-node GradP case (f32, 3
    snapshots): its trace must hold CUDA kernel events."""
    from porousfreezethaw_tpu_torch.apps.intertrack import main
    from porousfreezethaw_tpu_torch.cases import freezing_params_text

    text = freezing_params_text(grid_nodes=12, calc_mode=0,
                                final_time_hours=5.0 / 3600.0,
                                saved_files=3)
    text += ("\nset ball_positions_file = "
             + os.path.join(REPO, "data", "spheres_positions.txt") + "\n")
    out = tempfile.mkdtemp(prefix="pft_chip_smoke_profile_")
    old = os.environ.get("OUTPUT")
    try:
        pfile = os.path.join(out, "Params")
        with open(pfile, "w") as f:
            f.write(text)
        os.environ["OUTPUT"] = out
        prof = os.path.join(out, "profile")
        rc = main([pfile, "--precision", "f32", "--device", str(dev),
                   "--profile-dir", prof])
        with open(os.path.join(prof, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
        shutil.rmtree(out, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    emit("app_profile", rc=rc, events=len(events),
         cuda_kernel_events=len(kernels),
         kernel_names=sorted({e["name"][:40] for e in kernels})[:8])
    if rc != 0 or not kernels:
        raise AssertionError(f"app --profile-dir: rc={rc}, "
                             f"{len(kernels)} CUDA kernel events")


# the LR GradP goldens' counts to snapshot 1 on an H100, the host loop's
# (PERF.md), which the device loop keeps
GOLDEN_COUNTS = {"plain": (3637, 4309), "compensated": (3648, 4327)}


def phase_app(dev, idle_attempt_ms=None):
    """The goldens and a profiled run; returns the launch counters of the
    main-path runs of fused_stage, delta_g, merson_control and commit (the
    plain golden, through the app's chunked device loop), delta_g_dy
    (the compensated one) and merson_control_f64 and commit_f64 (the f64
    LR Temp golden, through the app's device loop on PlainAttempt, whose
    route is the float64 stage kernel), and the host loop's LR Temp golden
    record (the plain right-hand side's), and fused_stage_f64 (the f64
    golden's fused_stage launches).  The plain golden and the f64 golden
    also run through the host loop (the app's uses_device_loop patched):
    the same counts, RK debug log lines and snapshot 1, byte for byte.

    Launches: the host loop's are the attempts times the path's launches
    per attempt (none on the f64 path); the device loop's (on the f64
    path 5 fused_stage launches for each control launch) are one number
    of attempt launches for every kernel of the path, no fewer than the
    attempts: whole blocks of BLOCK attempts and the idle attempt before
    the capture.  ``idle_attempt_ms`` (phase controller's LR Temp f64
    row, when it ran) prices the f64 golden's idle attempts."""
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK

    runs = {}
    for key, golden, precision, extra, ref, controller in (
            ("plain", "Params-LR-GradP", "f32", "",
             (GOLDEN_STEPS, GOLDEN_ATTEMPTS), "auto"),
            ("plain_host", "Params-LR-GradP", "f32", "",
             (GOLDEN_STEPS, GOLDEN_ATTEMPTS), "host"),
            ("compensated", "Params-LR-GradP", "f32",
             "compensated_commit 1\n", (GOLDEN_STEPS, GOLDEN_ATTEMPTS),
             "auto"),
            ("f64", "Params-LR-Temp", "f64", "",
             (TEMP_STEPS, TEMP_ATTEMPTS), "auto"),
            ("f64_host", "Params-LR-Temp", "f64", "",
             (TEMP_STEPS, TEMP_ATTEMPTS), "host")):
        res = _app_run(dev, golden, precision, extra, controller)
        _within(res, *ref)
        n = res["attempts"]
        path = {"plain": "delta", "plain_host": "delta",
                "compensated": "delta_comp"}.get(key)
        device_loop = key in ("plain", "compensated", "f64")
        if key == "f64":
            # the float64 stage kernel's route: five fused_stage launches
            # an attempt, then the float64 control and commit kernels
            got = res["launches"]
            m = got["commit_f64"]
            others = {k: c for k, c in got.items()
                      if c and k not in ("merson_control_f64", "commit_f64",
                                         "fused_stage")}
            if got["fused_stage"] != 5 * m:
                others["fused_stage"] = got["fused_stage"]
            if "Float64 stage kernel: ON" not in res["log"]:
                raise AssertionError("f64 golden: the float64 stage kernel "
                                     "is not logged")
            idle = m - n
            emit("app_launches", golden=key, attempts=n,
                 attempt_launches=m, idle_attempts=idle,
                 idle_attempt_ms=idle_attempt_ms,
                 idle_share_of_solver_wall=(
                     idle * idle_attempt_ms / (1e3 * res["solver_wall_s"])
                     if idle_attempt_ms and res["solver_wall_s"]
                     else "not measured"))
            if (got["merson_control_f64"] != m or m < n
                    or (m - 1) % BLOCK or others):
                raise AssertionError(f"f64 golden: launch counts {got} "
                                     f"for {n} attempts")
        elif path is None:
            if any(res["launches"].values()):
                raise AssertionError(f"{key} golden: kernel launches "
                                     f"{res['launches']}")
        else:
            m = _path_attempts(res["launches"], path, device_loop)
            ok = (m >= n and (m - 1) % BLOCK == 0 if device_loop
                  else m == n)
            emit("app_launches", golden=key, attempts=n,
                 attempt_launches=m, idle_attempts=m - n)
            if not ok:
                raise AssertionError(f"{key} golden: launch counts "
                                     f"{res['launches']} for {n} attempts")
        if key == "compensated" and "(compensated commit)" not in res["log"]:
            raise AssertionError("the app ignored compensated_commit 1")
        if device_loop != ("Step control: device loop" in res["log"]):
            raise AssertionError(f"{key} golden: the step control logged "
                                 f"is not the one expected")
        counts = GOLDEN_COUNTS.get(key.replace("_host", ""))
        if counts and (res["steps"], res["attempts"]) != counts:
            raise AssertionError(f"{key} golden: {res['steps']}/"
                                 f"{res['attempts']}, want {counts}")
        if len(res["rk"]) != res["steps"]:
            raise AssertionError(f"{key} golden: {len(res['rk'])} RK log "
                                 f"lines for {res['steps']} steps")
        runs[key] = res
    for key in ("plain", "f64"):
        a, b = runs[key], runs[key + "_host"]
        # on the f64 golden the device loop runs the float64 stage kernel
        # and the host loop the plain right-hand side: at LR Temp the
        # kernel's correctly rounded operations give PyTorch's bits
        same = dict(counts=(a["steps"], a["attempts"]) == (b["steps"],
                                                           b["attempts"]),
                    rk_log_lines=a["rk"] == b["rk"],
                    snapshot_1=a["snapshot"] == b["snapshot"])
        emit("app_controllers", golden=key, device_loop_s=a["solver_wall_s"],
             host_loop_s=b["solver_wall_s"],
             device_ms_per_attempt=a.get("ms_per_attempt"),
             host_ms_per_attempt=b.get("ms_per_attempt"), **same)
        if not all(same.values()):
            raise AssertionError(f"the app's device loop and host loop "
                                 f"differ on the {key} golden: {same}")
    _app_profile(dev)
    launches = {k: runs["plain"]["launches"][k] for k in (
        "fused_stage", "delta_g", "merson_control", "commit")}
    launches["delta_g_dy"] = runs["compensated"]["launches"]["delta_g_dy"]
    for k in ("merson_control_f64", "commit_f64"):
        launches[k] = runs["f64"]["launches"][k]
    launches["fused_stage_f64"] = runs["f64"]["launches"]["fused_stage"]
    # the plain right-hand side's f64 golden (the host loop's), which the
    # halo path at z3 equals bit for bit
    return launches, runs["f64_host"]


# --------------------------------------------------------------------------
# phase 7: the mesh paths, on virtual shards of the one card
# --------------------------------------------------------------------------

# (spec, shards) of the bitwise checks; the solves use z4 and z2,y2
# z2,y3 splits MR's 100 rows into y windows of 34, 33 and 33
MESH_SPECS = (("z1", 1), ("z2", 2), ("z4", 4), ("z2,y2", 4), ("y2", 2),
              ("z2,y3", 6))
MESH_ATTEMPTS = 100
MESH_KERNELS = ("fused_stage_shard", "fused_stage_split", "delta_g_shard",
                "delta_g_shard_dy")
COLD_SETS = 5          # input sets rotated for K2s's L2-cold time


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
    # at the edges of the tiles: a z4 shard of one own row; the top three
    # planes (fewer than a chunk; the interior pass is one plane) with 13
    # own rows at the y chain end
    edges = (((zq, 2 * zq), slice(half - 1, half + 2), (1, 1, half), False),
             ((Z - 3, Z), slice(86, None), (1, 13, 87), True))
    for mode in (0, 1, 2):
        spec = st.StencilSpec.of(geom, prm, mode)
        for t in (prm.phase_switch_time - 0.5 * h,
                  prm.phase_switch_time + 1.0):
            for planes, rows, window in shards + tuple(e[:3] for e in edges):
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
            for planes, rows, window, is_top in (
                    (*shards[0], False), (*shards[2], False), (*top, True),
                    *edges):
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
    the bytes bound of the launch: (ms, plain_ms, bound, bytes, device_ms,
    L2-cold device_ms) by kernel; and the device ms of K3's interior and
    edge passes apart and of one launch's floor."""
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
    # K3's two passes on their own, and one launch's floor: a kernel that
    # writes one float
    prev0 = st.fused_stage_shard(spec, t, h, ws0, [], None, window=win,
                                 part="interior")
    one = torch.empty(1, device=dev)
    passes = {"interior": lambda: st.fused_stage_shard(
                  spec, t, h, ws0, [], None, window=win, part="interior"),
              "edge": lambda: st.fused_stage_shard(
                  spec, t, h, ws0, [], g0, window=win, part="edge",
                  prev=(prev0,)),
              "launch_floor": lambda: one.fill_(0.0)}
    cases["delta_g_shard"] = []
    for cs, s5 in DELTA_CASES.values():
        ws, kk, g = _shard_case(w, ks, len(cs), planes, rows)
        kk = list(zip(cs, kk))
        cases["delta_g_shard"].append((
            lambda f, ws=ws, kk=kk, g=g, s5=s5: f(
                spec, h, D1, 0.0, ws, kk, g, is_top=False, window=win,
                stage5=s5),
            _shard_cost(DELTA_OPS, ws, len(cs), ny, s5)))
    # K2s with its inputs cold in L2: each call takes the next of
    # COLD_SETS input sets of the same shard, 18-22 MB each, so the 50 MB L2
    # holds none of a call's inputs when it starts
    cold, grids = [], [_inputs(MR_SHAPE, dev, rng) for _ in range(COLD_SETS)]
    for cs, s5 in DELTA_CASES.values():
        sets = [_shard_case(*wk, len(cs), planes, rows) for wk in grids]
        turn = iter(range(1 << 30))

        def call(f, sets=sets, cs=cs, s5=s5, turn=turn):
            ws, kk, g = sets[next(turn) % COLD_SETS]
            return f(spec, h, D1, 0.0, ws, list(zip(cs, kk)), g,
                     is_top=False, window=win, stage5=s5)
        cold.append(call)
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
    split_ms = {k: _queued_ms(f, 10) for k, f in passes.items()}
    emit("mesh_kernel_times", impl="kernel_device_split",
         shard=[zq] + list(MR_SHAPE[1:]), ms=split_ms)
    cold_ms = float(np.mean([_queued_ms(lambda c=c: c(st.delta_g_shard),
                                        2 * COLD_SETS) for c in cold]))
    emit("mesh_kernel_times", impl="kernel_device_l2_cold",
         shard=[zq] + list(MR_SHAPE[1:]), ms={"delta_g_shard": cold_ms})
    out = {}
    for kern, calls in cases.items():
        nbytes = float(np.mean([b for _, (b, _) in calls]))
        ops = float(np.mean([o for _, (_, o) in calls]))
        out[kern] = (float(np.mean([timing["kernel"][kern],
                                    timing["kernel2"][kern]])),
                     float(np.mean([timing["plain"][kern],
                                    timing["plain2"][kern]])),
                     _bound(nbytes, ops), nbytes,
                     timing["kernel_device"][kern],
                     cold_ms if kern == "delta_g_shard" else None)
    return out, split_ms


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


def _mesh_dev_entries(dev):
    """The shard kernels' _dev entries (fused_stage_shard_dev: K1s and
    K3's interior and edge parts; delta_g_shard_dev: K2s and K2s-dy)
    against their by-value entries at MR shards, bit for bit (outputs and
    eps slots): every stage of both kernels, the scalars from a control
    block with t on each side of the phase switch, calc modes 0/1/2; the
    shards: a z4 shard, the top z4 shard (the classic stage's Dirichlet
    top in the by-value entry's ghost stack, decided by the kernel in the
    _dev entry, is_top), the two y shards of z2,y2 (uneven windows: one
    at each y chain end) and the tiles' edges; then a halted block, on
    which both write nothing."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    _, prm = _mr_params()
    w, ks = _inputs(MR_SHAPE, dev, np.random.default_rng(SEED + 14))
    geom = GridGeometry(0.03, 0.03, 0.06, MR_SHAPE[2], MR_SHAPE[1],
                        MR_SHAPE[0])
    Z, Y, X = MR_SHAPE
    zq, half = Z // 4, Y // 2
    shards = (((zq, 2 * zq), slice(None), (0, Y, 0)),
              ((Z - zq, Z), slice(None), (0, Y, 0)),
              ((Z // 2, Z), slice(0, half + 1), (0, half, 0)),
              ((0, Z // 2), slice(half - 1, None), (1, half, half)),
              ((zq, 2 * zq), slice(half - 1, half + 2), (1, 1, half)),
              ((Z - 3, Z), slice(86, None), (1, 13, 87)))
    classic = [(q, cs, s5) for q, (cs, s5) in enumerate(
        STAGE_CASES.values())]
    delta = [(q, cs, s5) for q, (cs, s5) in enumerate(
        DELTA_CASES.values(), 1)]
    h, n_cmp = 0.05, 0
    for mode in (0, 1, 2):
        spec = st.StencilSpec.of(geom, prm, mode)
        for t in (prm.phase_switch_time - 0.5 * h,
                  prm.phase_switch_time + 1.0):
            c = _control_block(prm, t=t, h=h)
            block = ctl.ControlBlock(dev, torch.zeros(1, device=dev))
            block.write(c)
            pairs = []
            for (lo, hi), rows, win in shards:
                top, zl, Yl = hi == Z, hi - lo, win[1]

                def slots(fn, *a):
                    return st._eps_blocks(fn, dev, mode, *a)
                for q, cs, s5 in classic:
                    ws, kk, g = _shard_case(w, ks, len(cs), (lo, hi), rows)
                    kk = list(zip(cs, kk))
                    gd = (st._dirichlet_ghost(spec, c.ts[q], g, len(cs))
                          if top else g)
                    args = (spec, c.ts[q], c.h32, ws, kk)
                    n_all = slots("pft_stage_eps_blocks", 0, zl, Yl, X)
                    n_int = slots("pft_stage_eps_blocks", 1, zl, Yl, X)
                    n_edge = slots("pft_stage_eps_blocks", 2, zl, Yl, X)
                    for split in (False, True):
                        if split:
                            prev = st.fused_stage_shard(
                                *args, None, window=win, stage5=s5,
                                part="interior")
                            ref = st.fused_stage_shard(
                                *args, gd, window=win, stage5=s5,
                                part="edge", prev=prev if s5 else (prev,))
                        else:
                            ref = st.fused_stage_shard(*args, gd, window=win,
                                                       stage5=s5)
                        out = torch.empty((2, zl, Yl, X), device=dev)
                        eps = torch.empty(n_int + n_edge if split else n_all,
                                          device=dev)
                        parts = ((("interior", None, eps[:n_int]),
                                  ("edge", g, eps[n_int:])) if split
                                 else (("all", g, eps),))
                        for part, g_, e in parts:
                            st.fused_stage_shard_dev(
                                spec, block, q, ws, kk, g_, out, is_top=top,
                                window=win, stage5=s5, part=part,
                                eps=e if s5 else None)
                        pairs.append((ref, (out, eps) if s5 else out))
                for q, cs, s5 in delta:
                    ws, kk, g = _shard_case(w, ks, len(cs), (lo, hi), rows)
                    kk = list(zip(cs, kk))
                    for emit_ in (("y", "dy") if s5 else ("y",)):
                        kw = dict(is_top=top, window=win, stage5=s5,
                                  emit=emit_)
                        ref = st.delta_g_shard(spec, c.h32, c.D1, c.dD[q],
                                               ws, kk, g, **kw)
                        out = torch.empty((2, zl, Yl, X), device=dev)
                        eps = torch.empty(slots(
                            "pft_delta_eps_blocks", 2 if emit_ == "dy" else 1,
                            zl, Yl, X), device=dev)
                        st.delta_g_shard_dev(spec, block, q, ws, kk, g, out,
                                             eps=eps if s5 else None, **kw)
                        pairs.append((ref, (out, eps) if s5 else out))
            torch.cuda.synchronize()
            for ref, got in pairs:
                ref = ref if isinstance(ref, tuple) else (ref,)
                got = got if isinstance(got, tuple) else (got,)
                if not all(torch.equal(a, b) for a, b in zip(ref, got)):
                    raise AssertionError(
                        f"a shard _dev entry differs from its by-value "
                        f"entry (mode {mode}, t {t}, pair {n_cmp})")
                n_cmp += 1
    # a halted block: both _dev entries return at once
    c = _control_block(prm, halt=1)
    block = ctl.ControlBlock(dev, torch.zeros(1, device=dev))
    block.write(c)
    spec = st.StencilSpec.of(geom, prm, 0)
    (lo, hi), rows, win = shards[1]
    ws, kk, g = _shard_case(w, ks, 3, (lo, hi), rows)
    kk = list(zip(DELTA_CASES["stage5"][0], kk))
    out = torch.full((2, hi - lo, Y, X), 7.0, device=dev)
    eps = torch.full((st._eps_blocks("pft_stage_eps_blocks", dev, 0, 0,
                                     hi - lo, Y, X),), 7.0, device=dev)
    eps_d = torch.full((st._eps_blocks("pft_delta_eps_blocks", dev, 0, 1,
                                       hi - lo, Y, X),), 7.0, device=dev)
    st.fused_stage_shard_dev(spec, block, 4, ws, kk, g, out, is_top=True,
                             window=win, stage5=True, eps=eps)
    st.delta_g_shard_dev(spec, block, 4, ws, kk, g, out, is_top=True,
                         window=win, stage5=True, eps=eps_d)
    torch.cuda.synchronize()
    idle = bool((out == 7.0).all() and (eps == 7.0).all()
                and (eps_d == 7.0).all())
    res = dict(pairs=n_cmp, bitwise=True, halted_untouched=idle,
               modes=[0, 1, 2], shape=list(MR_SHAPE))
    emit("mesh_dev_entries", **res)
    if not idle:
        raise AssertionError("a shard _dev launch on a halted block wrote")
    return res


def _tree_equal(a, b) -> bool:
    """Two states bit for bit: tensors, or lists and dicts of them."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(a, b)


def _same_solve(a, b, gather=None) -> bool:
    """Status, t, h, counts, trace and state of two solves with a trace
    bit for bit, ``b``'s state gathered by ``gather`` first."""
    sa, sb = a[0], b[0]
    return (a[1] == b[1] and (sa.t, sa.h, sa.steps, sa.steps_total)
            == (sb.t, sb.h, sb.steps, sb.steps_total)
            and _tree_equal(sa.y, sb.y if gather is None else gather(sb.y))
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def _loop_row(st, what, host, device, single, dev_att, y_mesh, y_one, h0,
              params, gather, profiled=None) -> dict:
    """One mesh path from the same state through the host loop and the
    device loop on the mesh and the single-device device loop (``host``,
    ``device``, ``single``: ``(state, params) -> merson_solve's result``;
    ``params`` with a trace of its attempts): the device loop's first run
    captures the graph (its memory peak above what was allocated before
    it: the static buffers and the graph's pool), then one timed run of
    each; all bit for bit (state, t, h, counts, status, trace), the
    single-device one's state against the mesh's gathered.  Device ms and
    busy share of both mesh loops from one more run each under
    torch.profiler (CUDA activity), beside the launches the trace holds
    and those the counters added (a trace may lose records, _traced_run;
    these rows report both and hold the run's result bit for bit), or,
    with ``profiled`` = (host attempts, device attempts), from shorter
    runs of as many attempts (the profiler's cost grows with the kernels
    it records: the plain path launches thousands an attempt); the device
    ms are summed over the streams, so the overlap split, whose ghost
    copies run on a side stream, can show a busy share above 1."""
    import dataclasses as dc

    from torch.profiler import ProfilerActivity, profile

    from porousfreezethaw_tpu_torch.solvers.merson import merson_init
    dev = torch.device("cuda:0")

    def timed(solve, y):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(merson_init(y, 0.0, h0), params)
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0) / res[0].steps_total

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    first, first_ms = timed(device, y_mesh)
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    a, host_ms = timed(host, y_mesh)
    b, dev_ms = timed(device, y_mesh)
    timed(single, y_one)                        # captures its graph
    c, single_ms = timed(single, y_one)
    same = dict(host_loop=_same_solve(a, b), first_run=_same_solve(first, b),
                single_device=_same_solve(c, b, gather))
    n = b[0].steps_total
    loops = {}
    for i, (loop, solve, ms) in enumerate((("host", host, host_ms),
                                           ("device", device, dev_ms))):
        m = n if profiled is None else profiled[i]
        p = dc.replace(params, max_steps=m, record_trace=m)
        _reset_all(st)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = solve(merson_init(y_mesh, 0.0, h0), p)
            torch.cuda.synchronize()
        counted = _all_counters(st)
        if not (_same_solve(res, b) if profiled is None
                else res[0].steps_total == m):
            raise AssertionError(f"{what}: the profiled {loop} loop's "
                                 f"result differs")
        us, kernels, krows = _device_time(prof)
        dms = us / 1e3 / m if us else "not measured"
        loops[loop] = dict(
            ms_per_attempt=ms, device_ms_per_attempt=dms,
            busy_share=dms / ms if us else "not measured",
            launches_per_attempt=kernels / m if us else None,
            profiled_attempts=m, traced_launches=_profiled_launches(prof),
            counted_launches={name: sum(counted[k] for k in keys)
                              for name, keys in KERNEL_COUNTERS},
            top=[dict(kernel=k[:60], count=c_, us=u)
                 for u, k, c_ in krows[:5]])
    row = dict(path=what, attempts=n, steps=b[0].steps, t=b[0].t,
               host=loops["host"], device=loops["device"],
               speedup=host_ms / dev_ms, single_device_ms_per_attempt=single_ms,
               graph_capture_s=dev_att.device_loop(dev).capture_s,
               capture_run_peak_mb=peak_mb,
               first_run_ms_per_attempt=first_ms, bitwise=same)
    emit("mesh_loops", **row)
    if not all(same.values()) or n != params.max_steps:
        raise AssertionError(f"mesh loops {what}: {n} attempts, bit for "
                             f"bit {same}")
    return row


def _mesh_loops(dev) -> dict:
    """MR GradP f32, MESH_ATTEMPTS attempts from the bench's start state,
    each kernel path on the mesh through both loops (_loop_row): the z4
    delta attempt, its compensated commit, the classic z4 stage (overlap
    split, the bench's f32 growth floor) and the z2,y2 attempt."""
    import dataclasses as dc

    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.parallel import (
        gather_freezing_state, make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.fused import (
        ShardedDeltaAttempt, ShardedDeltaAttempt2D, ShardedStageAttempt,
        make_sharded_fused_stage)
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve, merson_solve_device)

    geom, prm, v, y0, h0 = _mr_state(dev)
    z4 = make_mesh("z4", [dev] * 4)
    zy = make_mesh("z2,y2", [dev] * 4)
    comp = dict(compensated=True)
    paths = (("delta_z4", z4, ShardedDeltaAttempt, {}, st.DeltaAttempt),
             ("compensated_z4", z4, ShardedDeltaAttempt, comp,
              st.DeltaAttemptComp),
             ("classic_z4_overlap", z4, ShardedStageAttempt, {},
              st.StageAttempt),
             ("delta_z2,y2", zy, ShardedDeltaAttempt2D, {}, st.DeltaAttempt))
    rows = {}
    for name, mesh, cls, kw, single_cls in paths:
        classic = name.startswith("classic")
        params = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                              handle_nan=True, max_steps=MESH_ATTEMPTS,
                              record_trace=MESH_ATTEMPTS,
                              accept_growth_min=1.05 if classic else 0.0)
        dev_att = cls(geom, prm, 0, mesh, **kw)
        single_att = single_cls(geom, prm, 0)
        if classic:
            stage_fn = make_sharded_fused_stage(geom, prm, 0, mesh)

            def host(s, p, stage_fn=stage_fn):
                return merson_solve(None, s, 1e9, p, stage_fn=stage_fn)
        else:
            host_att = cls(geom, prm, 0, mesh, **kw)

            def host(s, p, host_att=host_att):
                return merson_solve(None, s, 1e9, p, attempt_fn=host_att)
        # the kernels' first use (their attributes and occupancy queries)
        # before the timed runs
        host(merson_init(shard_freezing_state(y0, mesh), 0.0, h0),
             dc.replace(params, max_steps=2, record_trace=0))
        rows[name] = _loop_row(
            st, name, host,
            lambda s, p, a=dev_att: merson_solve_device(s, 1e9, p, a),
            lambda s, p, a=single_att: merson_solve_device(s, 1e9, p, a),
            dev_att, shard_freezing_state(y0, mesh), y0, h0, params,
            lambda ys, mesh=mesh: gather_freezing_state(ys, mesh))
    return rows


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


def _mesh_per_attempt(shards, compensated=False) -> dict:
    """The launches of one attempt of the device loop on a z mesh of
    ``shards`` shards by counter: the delta attempt (stage 1 in K3's two
    passes, the overlap split), one control, one commit a shard."""
    per = {"fused_stage_split": 2 * shards,
           "delta_g_shard": (3 if compensated else 4) * shards,
           "merson_control": 1, "commit": shards}
    if compensated:
        per["delta_g_shard_dy"] = shards
    return per


def _mesh_goldens(dev) -> dict:
    """The LR GradP golden to snapshot 1 without a mesh, with --mesh z1
    through the app, and through run_iteration on a z4 mesh of the card
    (plain and compensated commit), every run through the app's chunked
    device loop (the log says so and names the mesh): the same counts and
    a byte-identical snapshot 1; the launches whole blocks of BLOCK
    attempts of the path's kernels, and the idle attempt before the
    capture.  Returns the main-path launches of K3 and K2s (the plain z4
    run) and K2s-dy (the compensated z4 run)."""
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK

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
        m = _attempts_of(run[3], _mesh_per_attempt(shards, bool(extra)),
                         f"golden {extra.strip()} --mesh {mesh_axes}")
        emit("mesh_golden_launches", extra=extra.strip(), mesh=mesh_axes,
             attempts=run[1], attempt_launches=m, idle_attempts=m - run[1])
        if run[:2] != base[:2] or run[2] != base[2]:
            raise AssertionError(
                f"golden {extra.strip()} --mesh {mesh_axes}: {run[:2]} "
                f"against {base[:2]} without a mesh, snapshot equal "
                f"{run[2] == base[2]}")
        if m < n or (m - 1) % BLOCK:
            raise AssertionError(f"golden {extra.strip()} --mesh "
                                 f"{mesh_axes}: launches {run[3]} for {n} "
                                 f"attempts in blocks of {BLOCK}")
        if not ("Step control: device loop" in run[4]
                and f"{shards} shards on" in run[4]):
            raise AssertionError(f"golden --mesh {mesh_axes}: the log does "
                                 f"not name the device loop on the mesh")
        if mesh_axes == "z4" and not extra:
            launches["fused_stage_split"] = run[3]["fused_stage_split"]
            launches["delta_g_shard"] = run[3]["delta_g_shard"]
        elif mesh_axes == "z4":
            launches["delta_g_shard_dy"] = run[3]["delta_g_shard_dy"]
    return launches


def _mesh_bench(dev) -> int:
    """The bench's MR mesh rows (bench.py's freezing_200_0_sharded and
    _sharded_2d) on the device loop (the classic z1 stage, ShardedStage-
    Attempt; the z1,y1 attempt); returns the K1s launches of the z1,y1
    row, its main path."""
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
        per = ({"fused_stage_split": 10} if mesh == "z1" else
               {"fused_stage_shard": 1, "delta_g_shard": 4})
        per.update(merson_control=1, commit=1)
        m = _attempts_of(launches, per, f"mesh bench row {mesh}")
        # one warm-up solve call and the timed one, each of whole blocks,
        # and the idle attempt before the capture
        want = _graph_attempts([rec["warm_attempts"], rec["attempts"]], 1)
        if not (rec["value"] > 0 and rec["controller"] == "device"
                and rec["metric"] == bench.HEADLINE + "_sharded_" + mesh):
            raise AssertionError(f"mesh bench row {mesh}: {rec}")
        if m != want:
            raise AssertionError(f"mesh bench row {mesh}: launches "
                                 f"{launches}, {m} attempts, want {want}")
        if mesh == "z1,y1":
            k1s = launches["fused_stage_shard"]
    return k1s


# the LR Temp f64 golden's counts on one card, for phase mesh run without
# phase app
TEMP_DEVICE_COUNTS = (1824, 2256)
# attempts of the plain halo paths through both loops (whole blocks of
# BLOCK), and of their profiled runs: the host loop's, the device loop's
PLAIN_MR_ATTEMPTS, PLAIN_NOISE_ATTEMPTS = 64, 64
PLAIN_PROFILED = (8, 32)


def _temp_golden_z3(dev, single=None) -> dict:
    """The LR Temp golden (f64) to snapshot 1 through run_iteration on a
    z3 mesh of the card: n3 = 100 in windows of 34, 33 and 33 planes, the
    plain right-hand side with halo copies, through the app's chunked
    device loop (PlainAttempt on the shards; the float64 control and
    commit kernels in whole blocks, one commit for all shards); the counts
    and snapshot bytes of the single-device plain right-hand side's run
    ``single`` (phase app's host-loop record), or without it the counts
    TEMP_DEVICE_COUNTS."""
    from porousfreezethaw_tpu_torch.apps.intertrack import run_iteration
    from porousfreezethaw_tpu_torch.config import parse_param_file
    from porousfreezethaw_tpu_torch.io.rklog import RunLog
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK

    text = open(os.path.join(REPO, "tests", "golden",
                             "Params-LR-Temp")).read()
    text = re.sub(r"final_time\s+\S+", "final_time 10*hours/99", text)
    text = re.sub(r"saved_files\s+\S+", "saved_files 2", text)
    text += ("\nset ball_positions_file = "
             + os.path.join(REPO, "data", "spheres_positions.txt") + "\n")
    out = tempfile.mkdtemp(prefix="pft_chip_smoke_temp_z3_")
    old = os.environ.get("OUTPUT")
    try:
        os.environ["OUTPUT"] = out
        pf = parse_param_file(text)
        log = RunLog(pf.setting("logfile"))
        _reset_all(st)
        t0 = time.perf_counter()
        stats = run_iteration(pf, log, device=dev, dtype=torch.float64,
                              mesh_axes="z3", mesh_devices=[dev] * 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c for k, c in _all_counters(st).items() if c}
        log.close()
        text_log = open(os.path.join(out, "intertrack.log")).read()
        snap = open(os.path.join(out, "image.001.ncd"), "rb").read()
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
        shutil.rmtree(out, ignore_errors=True)
    want = ((single["steps"], single["attempts"]) if single
            else TEMP_DEVICE_COUNTS)
    got = (stats["steps"], stats["steps_total"])
    same_bytes = (snap == single["snapshot"] if single
                  else "not compared (phase app did not run)")
    m = launches.get("commit_f64", 0)
    rec = dict(golden="Params-LR-Temp", precision="f64", mesh="z3",
               windows=[34, 33, 33], steps=got[0], attempts=got[1],
               single_device=list(want), snapshot_equal=same_bytes,
               wall_s=wall, ms_per_attempt=1e3 * wall / got[1],
               single_device_ms_per_attempt=(
                   single.get("ms_per_attempt") if single
                   else "not measured"),
               launches=launches, attempt_launches=m,
               halo_path="Plain right-hand side with halo copies"
               in text_log,
               device_loop="Step control: device loop" in text_log)
    emit("mesh_plain_golden", **rec)
    if (got != want or same_bytes is False or not rec["halo_path"]
            or not rec["device_loop"]):
        raise AssertionError(f"LR Temp golden at z3: {rec}")
    if (set(launches) != {"merson_control_f64", "commit_f64"}
            or launches["merson_control_f64"] != m or m < got[1]
            or (m - 1) % BLOCK):
        raise AssertionError(f"LR Temp golden at z3: launches {launches} "
                             f"for {got[1]} attempts")
    return rec


def _mesh_plain_loops(dev) -> dict:
    """The plain halo path (PlainAttempt over make_halo_rhs on the
    shards) through both loops against the single-device PlainAttempt
    (_loop_row), f32 with the app's classic settings (growth 1.05, NaN
    backoff): MR GradP on z2,y2 for PLAIN_MR_ATTEMPTS attempts, and LR
    GradP with a noise field (u_noise_amp 0.01) at z2 for
    PLAIN_NOISE_ATTEMPTS; profiled over PLAIN_PROFILED attempts."""
    from porousfreezethaw_tpu_torch.models.freezing.attempt import (
        PlainAttempt)
    from porousfreezethaw_tpu_torch.models.freezing.equation import (
        make_noise_field, make_rhs)
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.parallel import (
        gather_freezing_state, make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.halo import make_halo_rhs
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_solve, merson_solve_device)

    out = {}
    for name, grid_nodes, spec, shards, amp, attempts in (
            ("mr_classic_z2,y2", 200, "z2,y2", 4, 0.0, PLAIN_MR_ATTEMPTS),
            ("lr_noise_z2", 100, "z2", 2, 0.01, PLAIN_NOISE_ATTEMPTS)):
        geom, prm, v, y0, h0 = _mr_state(dev, grid_nodes)
        prm = dataclasses.replace(prm, u_noise_amp=amp)
        noise = make_noise_field(geom, prm, 0, dtype=np.float32)
        mesh = make_mesh(spec, [dev] * shards)
        rhs = make_halo_rhs(geom, prm, 0, mesh, noise)
        att = PlainAttempt(rhs, geom.shape, torch.float32, mesh=mesh)
        single = PlainAttempt(make_rhs(geom, prm, 0, dev, noise=noise),
                              geom.shape, torch.float32)
        params = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                              handle_nan=True, max_steps=attempts,
                              record_trace=attempts, accept_growth_min=1.05)
        out[name] = _loop_row(
            st, name, lambda s, p, rhs=rhs: merson_solve(rhs, s, 1e9, p),
            lambda s, p, a=att: merson_solve_device(s, 1e9, p, a),
            lambda s, p, a=single: merson_solve_device(s, 1e9, p, a),
            att, shard_freezing_state(y0, mesh), y0, h0, params,
            lambda ys, mesh=mesh: gather_freezing_state(ys, mesh),
            profiled=PLAIN_PROFILED)
        out[name]["noise"] = noise is not None
    return out


def phase_mesh(dev, temp_f64=None):
    """The multi-device freezing paths on virtual shards of the card:
    the shard kernels against their plain versions and their times, their
    _dev entries against the by-value entries, the sharded paths against
    the single-device ones bit for bit, each mesh path through the device
    loop and the host loop at MR (the kernel paths) and MR and LR (the
    plain halo path), the LR Temp golden at z3 on the halo device loop
    against ``temp_f64`` (phase app's host-loop run of the plain
    right-hand side), the LR golden at z4 and the
    bench's mesh rows on the device loop.  Returns the kernel summary rows
    of K1s, K3, K2s and K2s-dy and their main-path launches."""
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.parallel.fused import (
        halo_bytes_per_attempt)

    stats = _mesh_kernels(dev)
    dev_entries = _mesh_dev_entries(dev)
    _mesh_bitwise(dev)
    times, split_ms = _mesh_times(dev)
    _mesh_loops(dev)
    _mesh_plain_loops(dev)
    _temp_golden_z3(dev, temp_f64)
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
        (ms, plain_ms, (bound_ms, bound_by), nbytes, device_ms,
         cold_ms) = times[kern]
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
            bound_share=bound_ms / device_ms,
            dev_entry_bitwise_pairs=dev_entries["pairs"],
            timed=f"{timed} on one z4 shard of {MR_SHAPE} "
                  f"({MR_SHAPE[0] // 4} planes), {nbytes / 1e6:.1f} MB per "
                  f"launch{TIMED_BY}")
    for kern in out:
        out[kern]["ptxas"] = _row_ptxas(kern)
    out["fused_stage_split"].update(
        device_ms_interior=split_ms["interior"],
        device_ms_edge=split_ms["edge"],
        launch_floor_ms=split_ms["launch_floor"])
    cold = times["delta_g_shard"][5]
    out["delta_g_shard"].update(
        device_ms_l2_cold=cold,
        bound_share_l2_cold=out["delta_g_shard"]["bound_ms"] / cold)
    return out, launches


# --------------------------------------------------------------------------
# phase 8: the spheres DEM
# --------------------------------------------------------------------------

DEM_VARIANTS = ("basic", "basic_WB", "friction", "friction_angular")
DEM_N = 200
# the first ten snapshot intervals of the production case (T = 8, 400
# snapshots)
DEM_SHORT_T = 10 * 8.0 / 399
# the short solve's end state, card against CPU, per leaf relative to
# max|CPU| (f64; the same accept/reject sequence leaves only rounding)
DEM_STATE_TOL = 1e-10
# f32 on the card against f32 on the CPU, relative to max|ref| per leaf:
# the two order their float32 sums differently and nvcc contracts
# multiply-adds
DEM_F32_TOL = 1e-5
# (n, timed attempts, warm attempts) of the bench rows
# timed windows of a dozen blocks, so that rounding the last one up to
# BLOCK attempts stays a few percent of the row
DEM_BENCH_ROWS = ((200, 400, 100), (2000, 400, 20))
# the particle meshes of phase dem, virtual shards of the card: the right-
# hand side's check, the solve through both loops
DEM_MESH = "p4"
DEM_SOLVE_MESH = "p2"


def _dem_state(cfg, seed):
    """tests/test_dem.py's state at n spheres: the dense icond with random
    velocities and spins, and two spheres pushed into contact."""
    from porousfreezethaw_tpu_torch.models.dem import icond_dense
    state, _ = icond_dense(cfg, seed=seed)
    rng = np.random.RandomState(seed + 1)
    state["vel"] = rng.standard_normal((cfg.n, 3))
    if cfg.angular:
        state["angvel"] = 5.0 * rng.standard_normal((cfg.n, 3))
    state["pos"][1] = state["pos"][0] + [2 * cfg.r * 0.9, 0, 0]
    return state


def _device_time(prof):
    """(summed device us, kernel launches, top rows) of a torch.profiler
    run; (0, 0, []) when it recorded no device time."""
    rows = []
    for e in prof.key_averages():
        # the program's spans (core/tracing.py) and the profiler's steps
        # (_profiled) carry the device time of the kernels inside them
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith(("pft.", "ProfilerStep"))):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((float(us), e.key, e.count))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[2] for r in rows), rows


# phase tracing: solves of the benchmark's chunk at MR f32, in turns with
# tracing off and on, and the smallest device-idle gap the trace check
# names (us)
TRACING_ATTEMPTS = 1024
TRACING_RUNS = 9
TRACING_GAP_US = 10.0


def _span_reader(name):
    """The benchmark's reader ``metrics/<name>.py`` of the port's spans."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", os.path.join(REPO, "benchmark", "metrics",
                                       f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lambda: mod.read({}, {})


def _annotated_gaps(events, floor_us):
    """The device-idle gaps longer than ``floor_us`` between two device
    operations inside each ``pft.solve`` annotation of a Chrome trace, and
    the share of each that the ``pft.loop.*`` annotations cover:
    [(gap us, covered share, the innermost annotation at its middle)]."""
    def spans_of(pred):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("ph") == "X" and pred(e))

    device = spans_of(lambda e: str(e.get("cat", "")).lower() in (
        "kernel", "gpu_memcpy", "gpu_memset"))
    notes = spans_of(lambda e: e.get("cat") == "user_annotation"
                     and e["name"].startswith("pft."))
    loop = [(a, b) for a, b, n in notes if n.startswith("pft.loop.")]
    host = spans_of(lambda e: e.get("cat") in (
        "cpu_op", "cuda_runtime", "user_annotation"))
    out = []
    for s0, s1, _ in (n for n in notes if n[2] == "pft.solve"):
        busy = []
        for a, b, _ in device:
            if s0 <= a and b <= s1:
                if busy and a <= busy[-1][1]:
                    busy[-1][1] = max(busy[-1][1], b)
                else:
                    busy.append([a, b])
        for (_, g0), (g1, _) in zip(busy, busy[1:]):
            if g1 - g0 <= floor_us:
                continue
            covered, edge = 0.0, g0
            for a, b in loop:
                a, b = max(a, edge), min(b, g1)
                if b > a:
                    covered += b - a
                    edge = b
            mid = 0.5 * (g0 + g1)
            inner = [n for a, b, n in notes if a <= mid <= b]
            # what the host did over the gap, from its start (us)
            during = [(n, round(a - g0, 1), round(b - g0, 1))
                      for a, b, n in host if a < g1 and b > g0]
            out.append((g1 - g0, covered / (g1 - g0),
                        inner[-1] if inner else "none", during))
    return out


def phase_tracing(dev) -> None:
    """Optional: the port's spans on the card at MR f32 (the benchmark's
    mr-gradp.f32 attempt, DeltaAttempt on the GradP state, in solve calls
    of the app's 1024 attempts, each continuing the last):

    - tracing's cost: ms/attempt of TRACING_RUNS calls with tracing off
      and as many inside ``tracing.recording()``, in turns (off, on, on,
      off, ...), their medians; no profiler;
    - block_gap_us and boundary_host_us (the benchmark's readers of the
      spans) under ``tracing.recording()`` alone, and under torch.profiler;
    - ``capture_s`` against the capture span, the kernel library's load;
    - the app at MR f32 with --profile-dir: every device-idle gap of more
      than TRACING_GAP_US between two device operations inside a
      ``pft.solve`` annotation, and the share of it that ``pft.loop.*``
      annotations cover (a gap passes at 90%).
    """
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from porousfreezethaw_tpu_torch.apps import intertrack
    from porousfreezethaw_tpu_torch.cases import freezing_params_text
    from porousfreezethaw_tpu_torch.core import tracing
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK
    from porousfreezethaw_tpu_torch.ops.cuda.stencil import DeltaAttempt
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve_device)

    geom, prm, v, y0, _ = _mr_state(dev, 200)
    att = DeltaAttempt(geom, prm, 0)
    n = TRACING_ATTEMPTS
    mp = MersonParams(delta=v["delta"], h_min=v["tau_min"],
                      handle_nan=True, max_steps=n, record_trace=n)
    state = merson_init(y0, 0.0, v["tau"])
    gap, host = _span_reader("block_gap_us"), _span_reader("boundary_host_us")

    def one(mode):
        nonlocal state
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if mode == "off":
            state, _, _ = merson_solve_device(state, 1e9, mp, att)
        else:
            with tracing.recording():
                state, _, _ = merson_solve_device(state, 1e9, mp, att)
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0) / n

    one("off")                         # the capture and the first steps
    loop = att.device_loop(dev)
    capture = [s.seconds for s in tracing.spans()
               if s.name == "pft.loop.capture"]

    def block_means():
        """The last solve call's mean block device_us and its mean
        replay span (the host's launch of the graph), in us."""
        root = [s for s in tracing.spans() if s.name == "pft.solve"][-1]
        mine = [s for s in tracing.spans() if s.root == root.id]
        return (statistics.mean(s.attrs["device_us"] for s in mine
                                if s.name == "pft.loop.block"),
                statistics.mean(1e6 * s.seconds for s in mine
                                if s.name == "pft.loop.replay"))

    ms = {"off": [], "on": []}
    gaps, hosts, device_us, replay_us = [], [], [], []
    for k in range(TRACING_RUNS):
        for mode in (("off", "on") if k % 2 == 0 else ("on", "off")):
            ms[mode].append(one(mode))
            if mode == "on":
                gaps.append(gap())
                hosts.append(host())
                d, r = block_means()
                device_us.append(d)
                replay_us.append(r)
    prof_gaps, prof_hosts, busy_us = [], [], []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _, _ = merson_solve_device(state, 1e9, mp, att)
            torch.cuda.synchronize(dev)
        prof_gaps.append(gap())
        prof_hosts.append(host())
        # the device time of a block's operations (the graph's kernels)
        busy_us.append(_device_time(prof)[0] * BLOCK / n)
    med = {m: statistics.median(x) for m, x in ms.items()}
    emit("tracing", card=nvidia_smi(), attempts=n, runs=TRACING_RUNS,
         ms_per_attempt_off=ms["off"], ms_per_attempt_on=ms["on"],
         median_off=med["off"], median_on=med["on"],
         on_cost_pct=100.0 * (med["on"] / med["off"] - 1.0),
         paired_on_minus_off_us=statistics.median(
             1e3 * (a - b) for a, b in zip(ms["on"], ms["off"])),
         block_gap_us_recording=gaps, boundary_host_us_recording=hosts,
         block_device_us_recording=device_us,
         replay_host_us_recording=replay_us,
         block_busy_us_profiled=busy_us,
         block_gap_us_profiler=prof_gaps,
         boundary_host_us_profiler=prof_hosts,
         capture_s=loop.capture_s, capture_span_s=capture,
         kernel_library_s=_span_reader("kernel_library_s")())
    if capture != [loop.capture_s]:
        raise AssertionError(f"capture_s {loop.capture_s}, capture spans "
                             f"{capture}")

    # the app with --profile-dir: about two chunks of the MR f32 case
    out = tempfile.mkdtemp(prefix="pft-tracing-")
    try:
        pfile = os.path.join(out, "Params")
        with open(pfile, "w") as f:
            f.write(freezing_params_text(200, 0, final_time_hours=40.0
                                         / 3600.0, saved_files=3)
                    + "\nset ball_positions_file = "
                    + os.path.join(REPO, "data", "spheres_positions.txt")
                    + "\n")
        old = os.environ.get("OUTPUT")
        os.environ["OUTPUT"] = out
        # the collector's passes, as annotations of the trace
        collecting = []

        def gc_note(phase, info):
            if phase == "start":
                collecting.append(torch.profiler.record_function("gc"))
                collecting[-1].__enter__()
            elif collecting:
                collecting.pop().__exit__(None, None, None)

        gc.callbacks.append(gc_note)
        try:
            rc = intertrack.main([pfile, "--precision", "f32", "--device",
                                  "cuda", "--profile-dir", out])
        finally:
            gc.callbacks.remove(gc_note)
            if old is None:
                os.environ.pop("OUTPUT", None)
            else:
                os.environ["OUTPUT"] = old
        if rc != 0:
            raise AssertionError(f"the app exited {rc}")
        with open(os.path.join(out, "trace.json")) as f:
            text = f.read()
        events = json.loads(text)["traceEvents"]
        keep = os.path.join(REPO, "chiprun_out", "tracing")
        os.makedirs(keep, exist_ok=True)
        with gzip.open(os.path.join(keep, "app_trace.json.gz"), "wt") as f:
            f.write(text)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    found = _annotated_gaps(events, TRACING_GAP_US)
    passed = [g for g in found if g[1] >= 0.9]
    worst = sorted(found, key=lambda g: g[1])[:8]
    by_name = {}
    for us, _, name, _ in found:
        by_name[name] = by_name.get(name, 0.0) + us
    emit("tracing_app", gaps=len(found), passed=len(passed),
         share_passed=len(passed) / len(found) if found else None,
         gap_us_total=sum(g[0] for g in found),
         gap_us_by_annotation=by_name,
         worst=[dict(us=g[0], covered=g[1], at=g[2],
                     host=g[3][:12] if g[1] < 0.9 else None)
                for g in worst])


def _dem_rhs_checks(dev):
    from porousfreezethaw_tpu_torch.models.dem import DEMConfig, make_dem_rhs
    out = []
    for variant in DEM_VARIANTS:
        cfg = DEMConfig(variant=variant, n=DEM_N)
        state = _dem_state(cfg, SEED)
        for dtype, tol in ((torch.float64, 1e-12),
                           (torch.float32, DEM_F32_TOL)):
            ref = make_dem_rhs(cfg, dtype=dtype, device="cpu")(0.0, {
                k: torch.as_tensor(v, dtype=dtype) for k, v in
                state.items()})
            got = make_dem_rhs(cfg, dtype=dtype, device=dev)(0.0, {
                k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in
                state.items()})
            errs = {}
            for k, r in ref.items():
                g = got[k].cpu()
                if g.dtype != dtype or g.shape != r.shape:
                    raise AssertionError(f"dem rhs {variant}/{k}: "
                                         f"{g.dtype} {tuple(g.shape)}")
                scale = float(r.abs().max())
                errs[k] = float((g - r).abs().max()) / max(scale, 1e-300)
            row = dict(variant=variant, dtype=str(dtype)[6:], n=DEM_N,
                       tol=tol, max_rel_err=errs)
            emit("dem_rhs", **row)
            out.append(row)
            bad = {k: e for k, e in errs.items() if not e <= tol}
            if bad:
                raise AssertionError(f"dem rhs {variant} {dtype}: {bad} "
                                     f"above {tol}")
    return out


def _dem_short_solve(dev):
    """friction_angular, n = DEM_N, f64, dense icond seed 0, to DEM_SHORT_T
    through the device-resident loop (DEMAttempt through
    merson_solve_device) and the host loop (merson_solve) on the card, and
    the host loop on the CPU.  The two card loops give equal counts and
    state bits; their counts equal the CPU's, the state within
    DEM_STATE_TOL of it.  For each card loop: ms/attempt (the median of two
    unprofiled runs in turns), device ms and launches per attempt (each
    profiled once more, torch.profiler) and the busy share.  The device
    loop's first run captures its graph (capture_s) and is the main path
    of commit_f64_dem: the float64 control and commit counters, set to 0
    just before it, count whole blocks and the idle attempt before the
    capture.  The idle attempts (those launched past the loop's end) cost
    one idle attempt's device time each (an idle block's replay over its
    attempts)."""
    from torch.profiler import ProfilerActivity, profile

    from porousfreezethaw_tpu_torch.models.dem import (
        DEMAttempt, DEMConfig, icond_dense, make_dem_rhs)
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve, merson_solve_device)

    cfg = DEMConfig(variant="friction_angular", n=DEM_N)
    y0, _ = icond_dense(cfg, seed=0)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min)
    rhs = make_dem_rhs(cfg, dtype=torch.float64, device=dev)
    att = DEMAttempt(rhs)
    cpu_rhs = make_dem_rhs(cfg, dtype=torch.float64, device="cpu")

    def run(loop):
        device = torch.device("cpu") if loop == "cpu" else dev
        st0 = merson_init({k: torch.as_tensor(v, device=device)
                           for k, v in y0.items()}, 0.0, cfg.ht)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if loop == "device":
            res = merson_solve_device(st0, DEM_SHORT_T, params, att)
        else:
            res = merson_solve(cpu_rhs if loop == "cpu" else rhs, st0,
                               DEM_SHORT_T, params)
        torch.cuda.synchronize()
        return res[0], res[1], time.perf_counter() - t0

    _reset_counters(st)
    dev_st, dev_status, first_wall = run("device")
    counted = _counters(st)
    card, status, _ = run("host")
    cpu, cpu_status, cpu_wall = run("cpu")
    walls = {"host": [], "device": []}
    for loop in ("host", "device", "device", "host"):
        walls[loop].append(run(loop)[2])
    prof = {}
    for loop in ("host", "device"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            again = run(loop)[0]
        prof[loop] = (_device_time(p), again.steps_total)
    n = card.steps_total
    launched = counted["commit_f64"]
    idle_attempt_ms = _idle_block_ms(att, dev) / BLOCK
    same = (dev_status == status and (dev_st.t, dev_st.h, dev_st.steps, n)
            == (card.t, card.h, card.steps, dev_st.steps_total)
            and all(torch.equal(dev_st.y[k], card.y[k]) for k in card.y))
    # per leaf, the card's state against the CPU's relative to max|CPU|
    rel = {k: float((card.y[k].cpu() - cpu.y[k]).abs().max())
           / max(float(cpu.y[k].abs().max()), 1e-300) for k in y0}
    loops = {}
    for loop in ("host", "device"):
        (us, kernels, rows), m = prof[loop]
        med = float(np.median(walls[loop]))
        loops[loop] = dict(
            ms_per_attempt=1e3 * med / n,
            repeats_s=walls[loop],
            device_ms_per_attempt=us / 1e3 / m if us else "not measured",
            launches_per_attempt=kernels / m if us else None,
            busy_share=(us / 1e3 / m) / (1e3 * med / n) if us
            else "not measured",
            profiled_attempts=m,
            top=[dict(kernel=k[:60], count=c, us=u)
                 for u, k, c in rows[:6]])
    idle = launched - 1 - n
    rec = dict(variant="friction_angular", n=DEM_N, dtype="f64",
               t=card.t, steps=card.steps, attempts=n,
               cpu_steps=cpu.steps, cpu_attempts=cpu.steps_total,
               cpu_ms_per_attempt=1e3 * cpu_wall / n,
               loops_bitwise=same, host=loops["host"],
               device=loops["device"],
               speedup=(loops["host"]["ms_per_attempt"]
                        / loops["device"]["ms_per_attempt"]),
               block=BLOCK,
               graph_capture_s=att.device_loop(dev).capture_s,
               first_device_run_s=first_wall,
               attempt_launches=launched,
               control_launches=counted["merson_control_f64"],
               idle_attempts=idle, idle_attempt_ms=idle_attempt_ms,
               idle_share_of_wall=(idle * idle_attempt_ms
                                   / (1e3 * float(np.median(
                                       walls["device"])))),
               max_rel_state_diff=rel, state_tol=DEM_STATE_TOL)
    emit("dem_solve", **rec)
    rec["state"] = card.y
    rec["ms_per_attempt"] = loops["device"]["ms_per_attempt"]
    # the main path of commit_f64_dem (merson_control_f64's and
    # commit_f64's is the f64 LR golden, phase app)
    rec["launches"] = {"commit_f64_dem": launched}
    if not (status == cpu_status == 0 and same
            and prof["device"][1] == prof["host"][1] == n
            and (card.steps, n) == (cpu.steps, cpu.steps_total)):
        raise AssertionError(f"dem short solve: card {card.steps}/{n} "
                             f"status {status}, CPU {cpu.steps}/"
                             f"{cpu.steps_total} status {cpu_status}, "
                             f"the loops bitwise {same}")
    if not (launched == counted["merson_control_f64"] and launched >= n + 1
            and (launched - 1) % BLOCK == 0):
        raise AssertionError(f"dem short solve: {counted} for {n} "
                             f"attempts in blocks of {BLOCK}")
    bad = {k: e for k, e in rel.items() if not e <= DEM_STATE_TOL}
    if bad:
        raise AssertionError(f"dem short solve: state {bad} above "
                             f"{DEM_STATE_TOL} of max|CPU| per leaf")
    return rec


def _block_profile(dev, n, nb, cap) -> dict:
    """Device ms and kernel launches per attempt of the bench's bed of n
    spheres (f32, neighbor ``nb``, capacity ``cap``) through the device
    loop: torch.profiler over one replay of a block of BLOCK attempts,
    after the capture."""
    from torch.profiler import ProfilerActivity, profile

    from porousfreezethaw_tpu_torch.models.dem import (
        DEMAttempt, make_dem_rhs)
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve_device)

    cfg, y0 = _bed(n, moving=False)
    att = DEMAttempt(make_dem_rhs(cfg, dtype=torch.float32, neighbor=nb,
                                  cell_capacity=cap or 16, device=dev))
    st = merson_init({k: torch.as_tensor(v, dtype=torch.float32,
                                         device=dev)
                      for k, v in y0.items()}, 0.0, cfg.ht)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min,
                          handle_nan=True, max_steps=BLOCK)
    merson_solve_device(st, 1e9, params, att)     # captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        done = merson_solve_device(st, 1e9, params, att)[0].steps_total
        torch.cuda.synchronize()
    device_us, kernels, rows = _device_time(prof)
    if done != BLOCK:
        raise AssertionError(f"block profile at n = {n}: {done} attempts")
    return dict(device_ms_per_attempt=(device_us / 1e3 / done if device_us
                                       else "not measured"),
                launches_per_attempt=kernels / done if device_us else None,
                top=[dict(kernel=k[:50], count=c, us=us)
                     for us, k, c in rows[:5]])


def _dem_bench(dev):
    """The bench's dense DEM rows (f32) through the device loop, with the
    control and commit launches of each (whole blocks), the graph's
    capture time, the peak memory (the graph's pool included), and device
    ms and launches per attempt (_block_profile)."""
    from porousfreezethaw_tpu_torch import bench
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    recs = []
    for n, steps, warm in DEM_BENCH_ROWS:
        args = bench.parse_args(["--suite", "dem", "--device", str(dev),
                                 "--steps", str(steps), "--warm-steps",
                                 str(warm)])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counters(st)
        rec = bench.bench_dem(args, n_spheres=n)
        rec["peak_memory_mb"] = torch.cuda.max_memory_allocated(dev) / 1e6
        rec["launches"] = {k: c for k, c in _counters(st).items() if c}
        rec.update(_block_profile(dev, n, "dense", 0))
        emit("dem_bench", **rec)
        if not (rec["value"] > 0 and rec["metric"]
                == f"dem_{n}_particle_rhs_evals_per_s"
                and rec["device"] == torch.cuda.get_device_name(dev)
                and rec["controller"] == "device"
                and rec["launches"].get("commit", 0)
                >= warm + steps + 1):
            raise AssertionError(f"dem bench row {n}: {rec}")
        recs.append(rec)
    return recs


def _dem_mesh(dev, short) -> None:
    """The particle-sharded dense term on virtual shards of the card at
    n = 200, f64: on DEM_MESH, the right-hand side of the four variants
    bit for bit against the single-device one; on DEM_SOLVE_MESH, the
    short solve through the device loop (DEMAttempt on the shards' dicts:
    CUDA graphs, the float64 control and commit kernels) and the host
    loop, bit for bit (state, t, h, counts, status, trace), and both with
    the single-device counts and state bits of ``short``; ms/attempt of
    both (the device loop's second run, after its capturing first), the
    capture time."""
    from porousfreezethaw_tpu_torch.models.dem import (
        DEMAttempt, DEMConfig, icond_dense, make_dem_rhs)
    from porousfreezethaw_tpu_torch.parallel import (
        gather_dem_state, make_mesh, shard_dem_state)
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve, merson_solve_device)

    mesh = make_mesh(DEM_MESH, [dev] * int(DEM_MESH[1:]))
    bitwise = {}
    for variant in DEM_VARIANTS:
        cfg = DEMConfig(variant=variant, n=DEM_N)
        y = {k: torch.as_tensor(v, device=dev)
             for k, v in _dem_state(cfg, SEED).items()}
        want = make_dem_rhs(cfg, device=dev)(0.0, y)
        got = gather_dem_state(make_dem_rhs(cfg, mesh=mesh)(
            0.0, shard_dem_state(y, mesh)))
        bitwise[variant] = all(torch.equal(got[k], want[k]) for k in want)
    cfg = DEMConfig(variant="friction_angular", n=DEM_N)
    y0, _ = icond_dense(cfg, seed=0)
    mesh = make_mesh(DEM_SOLVE_MESH, [dev] * int(DEM_SOLVE_MESH[1:]))
    y = shard_dem_state({k: torch.as_tensor(v, device=dev)
                         for k, v in y0.items()}, mesh)
    rhs = make_dem_rhs(cfg, mesh=mesh)
    att = DEMAttempt(rhs)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min,
                          record_trace=short["steps"])

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st0 = merson_init(y, 0.0, cfg.ht)
        res = (merson_solve_device(st0, DEM_SHORT_T, params, att)
               if loop == "device" else
               merson_solve(rhs, st0, DEM_SHORT_T, params))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    first, first_wall = run("device")
    dev_res, dev_wall = run("device")
    host_res, host_wall = run("host")
    st = host_res[0]
    full = gather_dem_state(st.y)
    same = dict(loops=_same_solve(host_res, dev_res),
                first_run=_same_solve(first, dev_res),
                single_device_state=all(torch.equal(full[k],
                                                    short["state"][k])
                                        for k in full))
    rec = dict(rhs_mesh=DEM_MESH, rhs_bitwise=bitwise,
               solve_mesh=DEM_SOLVE_MESH, n=DEM_N, steps=st.steps,
               attempts=st.steps_total,
               single_device=[short["steps"], short["attempts"]],
               bitwise=same,
               host_ms_per_attempt=1e3 * host_wall / st.steps_total,
               device_ms_per_attempt=1e3 * dev_wall / st.steps_total,
               speedup=host_wall / dev_wall,
               single_device_ms_per_attempt=short["ms_per_attempt"],
               graph_capture_s=att.device_loop(dev).capture_s,
               first_device_run_s=first_wall)
    emit("dem_mesh", **rec)
    if not (all(bitwise.values()) and host_res[1] == 0
            and all(same.values())
            and [st.steps, st.steps_total] == rec["single_device"]):
        raise AssertionError(f"dem mesh: {rec}")


def phase_dem(dev) -> dict:
    """The spheres DEM on the card: its right-hand side against the CPU's,
    a short solve against the CPU's step counts, the sharded dense term
    against the single-device one, the bench's DEM rows.  Returns the
    short solve's record."""
    _dem_rhs_checks(dev)
    short = _dem_short_solve(dev)
    _dem_mesh(dev, short)
    _dem_bench(dev)
    return short


# VALIDATION.md:61-80, the reference's LR Temp run (10 h, 100 snapshots):
# cumulative successful steps at snapshots 25/50/75/99, the attempts at 99,
# and the ice fraction's peak and its value at t = 36000 s
TEMP_FULL_STEPS = {25: 90809, 50: 184002, 75: 248935, 99: 288134}
TEMP_FULL_ATTEMPTS = 355469
TEMP_ICE_PEAK, TEMP_ICE_END = 0.5084, 0.0506


def phase_temp_f64_full(dev) -> dict:
    """Optional: the shipped LR Temp case (tests/golden/Params-LR-Temp,
    f64, 10 h, 100 snapshots) through the app's device loop on the card:
    the cumulative successful steps at snapshots 25/50/75/99 within 5% of
    the reference's (TEMP_FULL_STEPS) and the attempts at 99 within 5% of
    TEMP_FULL_ATTEMPTS; the ice fraction of the snapshots
    (analysis.series_statistics) peaking at TEMP_ICE_PEAK and reaching
    TEMP_ICE_END at t = 36000 s, each within 1e-3.  The app's log goes to
    chiprun_out/temp_f64_full/; the snapshots (600 MB) to a temporary
    directory, removed after (_app_series)."""
    res = _app_series(dev, "temp_f64_full", "temp_f64_full",
                      golden_text("Params-LR-Temp"), precision="f64",
                      stats=True)
    counts, stats = res["counts"], res["stats"]
    ice = stats["ice_fraction"]
    attempts = counts.get(99, (0, 0))[1]
    rec = dict(rc=res["rc"], wall_s=res["wall_s"],
               solver_wall_s=res["solver_wall_s"],
               device_loop=res["device_loop"],
               steps={k: counts.get(k, (None,))[0] for k in TEMP_FULL_STEPS},
               reference_steps=TEMP_FULL_STEPS, attempts=attempts,
               reference_attempts=TEMP_FULL_ATTEMPTS,
               ms_per_attempt=res["ms_per_attempt"],
               snapshots=len(ice), ice_peak=max(ice) if ice else None,
               ice_peak_t=stats["t"][int(np.argmax(ice))] if ice else None,
               ice_end=ice[-1] if ice else None,
               t_end=stats["t"][-1] if ice else None,
               reference_ice=[TEMP_ICE_PEAK, TEMP_ICE_END])
    emit("temp_f64_full", **rec)
    bad = [k for k, ref in TEMP_FULL_STEPS.items()
           if rec["steps"][k] is None
           or abs(rec["steps"][k] - ref) > 0.05 * ref]
    if (bad or len(ice) != 100
            or abs(attempts - TEMP_FULL_ATTEMPTS) > 0.05 * TEMP_FULL_ATTEMPTS
            or abs(rec["ice_peak"] - TEMP_ICE_PEAK) > 1e-3
            or abs(rec["ice_end"] - TEMP_ICE_END) > 1e-3
            or abs(rec["t_end"] - 36000.0) > 1e-3):
        raise AssertionError(f"temp_f64_full: {rec}")
    return rec


# --------------------------------------------------------------------------
# the production runs: phase hr (HR on every single-device path) and the
# optional full-length runs held to VALIDATION.md's records
# --------------------------------------------------------------------------

HR_GRID_NODES = 400
HR_SHAPE = (400, 200, 200)          # (n3, n2, n1): 16.0 M cells
# the bench rows at HR: (label, --fused, --dtype, --calc-mode, --steps,
# runs); the warm-up is one solve call of --steps attempts (bench.py's
# rule for --warm-steps 32), which captures the graph; 96 and 32 are
# whole blocks.  An f32 row's timed call lasts 0.15-0.25 s, so one host
# stall moves it (a 96-attempt run read 2.56 ms/attempt on 1.48 device
# ms): those rows take the median of 3 runs; the f64 row's lasts 3.5 s
HR_ROWS = (("delta", "delta", "f32", 0, 96, 3),
           ("delta_temp", "delta", "f32", 2, 96, 3),
           ("delta_comp", "delta", "f32", 0, 96, 3),
           ("stage", "stage", "f32", 0, 96, 3),
           ("fused_attempt", "attempt", "f32", 0, 96, 3),
           ("f64_plain", "off", "f64", 0, 32, 1))
HR_WARM = 32
HR_LOOP_ATTEMPTS = 64               # the delta path in both loops
# the step of HR's whole-attempt check: MR's h / dx^2 (_kernel_cases)
HR_CHAIN_H = 0.05 * (MR_SHAPE[0] / HR_SHAPE[0]) ** 2
# the app's run at HR: simulated seconds of the HR GradP case (about a
# thousand attempts from tau = 1, most of them the start's NaN backoff
# and small steps)
HR_APP_FINAL_TIME = 0.5


def golden_text(golden: str, grid_nodes=None, snapshots=None) -> str:
    """The Params text of ``tests/golden/<golden>`` (the shipped LR cases)
    with the repository's ball positions; at ``grid_nodes`` cells along
    the long side when given (the golden's grid lines appended: later
    definitions win); with ``snapshots`` = k, run to snapshot k of the case's
    99 (final_time 10*hours*k/99 and saved_files k + 1, appended: the
    snapshot times stay final_time * j / (saved_files - 1) = 36000 j /
    99 s, as VALIDATION.md's HR runs truncated the shipped Params).

    The HR Params: the shipped Cases-HR files are not in the repository;
    cases.py authors LR, MR and HR from one Params text at grid_nodes
    100/200/400 (BASELINE.md's grid convention), so the LR golden at
    grid_nodes 400 is the closest HR Params the repository holds."""
    text = open(os.path.join(REPO, "tests", "golden", golden)).read()
    text += ("\nset ball_positions_file = "
             + os.path.join(REPO, "data", "spheres_positions.txt") + "\n")
    if grid_nodes:
        text += (f"grid_nodes {grid_nodes}\n"
                 "multiplier grid_nodes / (L1 max L2 max L3)\n"
                 "n1 L1 * multiplier\nn2 L2 * multiplier\n"
                 "n3 L3 * multiplier\n")
    if snapshots:
        text += (f"final_time 10*hours*{snapshots}/99\n"
                 f"saved_files {snapshots + 1}\n")
    return text


def _trace_kernels(path: str):
    """(summed device us, launches) of the CUDA kernels in a Chrome trace
    of torch.profiler (bench --profile-dir)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return float(sum(e.get("dur", 0.0) for e in kernels)), len(kernels)


def _release() -> None:
    """Frees what earlier rows left on the card (attempts and their loops
    hold each other, so the collector runs first)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _hr_bench_row(dev, label, fused, dtype, mode, steps, runs,
                  trace_root):
    """One HR row of the port's bench (bench.bench_freezing at --grid-nodes
    400), run ``runs`` times: the record of the run with the median
    ms/attempt under bench.py's metric names, with every run's
    ms/attempt; each run's launch counters whole blocks of BLOCK attempts
    of the path's kernels (as phase bench checks);
    torch.cuda.max_memory_allocated over the first run (after the
    earlier rows' memory was freed); the device ms per attempt from one
    more bench run with --profile-dir (the CUDA kernels of its trace over
    its timed attempts), and the busy share: that over the median
    ms/attempt.  ``delta_comp`` runs the bench's delta row on
    DeltaAttemptComp (the app's compensated_commit 1)."""
    from porousfreezethaw_tpu_torch import bench
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    argv = ["--fused", fused, "--dtype", dtype, "--grid-nodes",
            str(HR_GRID_NODES), "--calc-mode", str(mode), "--steps",
            str(steps), "--warm-steps", str(HR_WARM), "--device", str(dev)]
    own = bench.DeltaAttempt
    if label == "delta_comp":
        bench.DeltaAttempt = st.DeltaAttemptComp
    trace_dir = os.path.join(trace_root, label)
    calls = [steps] * (max(1, -(-HR_WARM // steps)) + 1)
    path = {"delta": "delta", "delta_temp": "delta",
            "delta_comp": "delta_comp", "stage": "stage",
            "fused_attempt": "fused_attempt"}.get(label)
    graph = _graph_attempts(calls, 1)
    want = (_want_f64(graph) if path is None
            else _want_launches(path, graph, True))
    recs = []
    try:
        _release()
        base_mb = torch.cuda.memory_allocated(dev) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(runs):
            _reset_counters(st)
            rec = bench.bench_freezing(bench.parse_args(argv))
            torch.cuda.synchronize()
            launches = _counters(st)
            if not recs:
                peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
            recs.append(rec)
            _release()
            if (rec["controller"] != "device"
                    or not rec["graph_capture_s"] > 0):
                raise AssertionError(f"hr {label}: controller "
                                     f"{rec['controller']}, capture "
                                     f"{rec['graph_capture_s']}")
            if (rec["grid"] != [HR_SHAPE[2], HR_SHAPE[1], HR_SHAPE[0]]
                    or rec["attempts"] + rec["warm_attempts"] != sum(calls)
                    or not rec["value"] > 0):
                raise AssertionError(f"hr {label}: {rec}")
            if launches != {k: want.get(k, 0) for k in launches}:
                raise AssertionError(f"hr {label}: launches {launches}, "
                                     f"want {want}")
        prof = bench.bench_freezing(bench.parse_args(
            argv + ["--profile-dir", trace_dir]))
    finally:
        bench.DeltaAttempt = own
    us, n_kernels = _trace_kernels(os.path.join(trace_dir, "trace.json"))
    shutil.rmtree(trace_dir, ignore_errors=True)
    recs.sort(key=lambda r: r["ms_per_attempt"])
    rec = recs[len(recs) // 2]
    dms = us / 1e3 / prof["attempts"] if us else "not measured"
    row = dict(label=label, **rec, launches=launches,
               repeats=[r["ms_per_attempt"] for r in recs],
               capture_s=rec["graph_capture_s"],
               max_memory_allocated_mb=peak_mb,
               allocated_before_mb=base_mb,
               device_ms_per_attempt=dms,
               kernels_per_attempt=(n_kernels / prof["attempts"]
                                    if us else None),
               busy_share=(dms / rec["ms_per_attempt"] if us
                           else "not measured"),
               profiled_ms_per_attempt=prof["ms_per_attempt"])
    emit("hr_bench", **row)
    return row


def _hr_kernels(dev) -> dict:
    """K1, K2, K2' and K4 at HR: every variant against its plain version
    in calc modes 0/1/2 at a t half a step below the phase switch
    (_kernel_cases, phase kernels' tolerance), then each main-path
    variant's device ms (_queued_ms) and the plain version's ms beside
    its bound, as phase kernels times them at MR."""
    _, prm = _mr_params(HR_GRID_NODES)
    rng = np.random.default_rng(SEED + 400)
    per = _kernel_cases(dev, prm, HR_SHAPE, rng, (-0.5,),
                        chain_h=HR_CHAIN_H)
    _release()
    timing, bounds = _kernel_times(dev, prm, HR_SHAPE, rng,
                                   ("kernel", "kernel_device", "plain"))
    rows = {}
    for kern, cases, replaces, src in KERNEL_ROWS:
        def avg(impl):
            return float(np.mean([timing[impl][f"{kern}/{c}"]
                                  for c in cases]))
        costs = [bounds[f"{kern}/{c}"] for c in cases]
        bound_ms, bound_by = _bound(float(np.mean([b for b, _ in costs])),
                                    float(np.mean([o for _, o in costs])))
        errs = [s for (k, _), s in per.items() if k == kern]
        rows[kern] = dict(
            name=kern, shape=list(HR_SHAPE),
            replaces=f"porousfreezethaw_tpu/ops/pallas/stencil.py{replaces}",
            max_abs_err=max(s["max_abs_err"] for s in errs),
            max_rel_err=max(s["max_rel_err"] for s in errs),
            ms=avg("kernel"), device_ms=avg("kernel_device"),
            plain_ms=avg("plain"), bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / avg("kernel_device"),
            timed=f"{'+'.join(cases)} at {HR_SHAPE}" + TIMED_BY)
        emit("hr_kernel", **rows[kern])
    _release()
    return rows


def _hr_loops(dev) -> dict:
    """The delta path (DeltaAttempt) at HR in both loops: HR_WARM host-loop
    attempts from the bench's HR GradP case, then HR_LOOP_ATTEMPTS
    attempts from there through the device loop (its capture) and the
    host loop: status, t, h, counts, the (t, h) trace and the state bit
    for bit, the device loop's launches whole blocks of its kernels."""
    from porousfreezethaw_tpu_torch import bench
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init)

    n = HR_LOOP_ATTEMPTS
    v, geom, prm, w0 = bench.freezing_case(HR_GRID_NODES, 0, torch.float32)

    def params(max_steps, trace=0):
        return MersonParams(delta=v["delta"], h_min=v["tau_min"],
                            handle_nan=True, max_steps=max_steps,
                            record_trace=trace)

    host, device, _ = _loop_solvers("delta", geom, prm)
    y0 = torch.from_numpy(w0).to(dev)
    start = host(merson_init(y0, 0.0, min(v["tau"], 1e-4)),
                 params(HR_WARM))[0]
    _reset_counters(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = device(start, params(n, n))
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    launches = {k: c for k, c in _counters(st).items() if c}
    t0 = time.perf_counter()
    res = host(start, params(n, n))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    want = _want_launches("delta", _graph_attempts([n], 1), True)
    row = dict(grid=list(geom.shape), path="delta", attempts=n,
               steps=ref[0].steps - start.steps, t=ref[0].t, h=ref[0].h,
               status=ref[1], bitwise=_same_result(res, ref),
               launches=launches, device_loop_s=device_s,
               host_loop_s=host_s)
    emit("hr_loops", **row)
    if not row["bitwise"]:
        raise AssertionError("hr: the delta path's device loop differs from "
                             "its host loop")
    if launches != want:
        raise AssertionError(f"hr loops: launches {launches}, want {want}")
    return row


def _disk_room(path: str, nbytes: float, what: str) -> None:
    """Fails unless the file system of ``path`` has 1.25 ``nbytes`` free."""
    free = shutil.disk_usage(path).free
    if free < 1.25 * nbytes:
        raise AssertionError(f"{what}: {free / 2**30:.2f} GiB free under "
                             f"{path}, {1.25 * nbytes / 2**30:.2f} GiB "
                             f"needed for its snapshots")


SNAPSHOT_DONE = re.compile(r"Calculating snapshot (\d+) \.\.\. Done on .*?, "
                           r"(\d+) R-K steps \((\d+) total\)")


def _wall_s(log: str, what: str):
    m = re.search(what + r" wall time: (\d+):(\d+):(\S+)", log)
    return 3600 * int(m[1]) + 60 * int(m[2]) + float(m[3]) if m else None


def _app_series(dev, phase, label, text, precision="f32", stats=False,
                keep=None):
    """The intertrack app (``main`` on ``dev``, its device loop) on the
    Params ``text``, OUTPUT a new temporary directory that is removed
    after (its snapshots' size checked against the free disk first, from
    the grid and saved_files): the log kept as chiprun_out/<phase>/
    <label>.log; the cumulative (steps, attempts) at each snapshot,
    ``counts``, the solver and overall walls and whether the device loop
    ran; with ``stats`` the snapshots' series_statistics; ``keep`` = (file
    name, directory) copies that snapshot out before the directory goes.
    The launch counters are set to 0 before and read after."""
    from porousfreezethaw_tpu_torch.analysis import series_statistics
    from porousfreezethaw_tpu_torch.apps.intertrack import main
    from porousfreezethaw_tpu_torch.config import parse_param_file
    from porousfreezethaw_tpu_torch.ops.cuda import build
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    build.load_library()
    keep_dir = os.path.join(REPO, "chiprun_out", phase)
    os.makedirs(keep_dir, exist_ok=True)
    out = tempfile.mkdtemp(prefix=f"pft_chip_smoke_{label}_")
    v = parse_param_file(text, env={"OUTPUT": out}).vars
    width = 4 if precision == "f32" else 8
    _disk_room(out, 3 * width * v["n1"] * v["n2"] * v["n3"]
               * v["saved_files"], label)
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
        shutil.copy(os.path.join(out, "intertrack.log"),
                    os.path.join(keep_dir, f"{label}.log"))
        res = dict(label=label, rc=rc, wall_s=wall,
                   solver_wall_s=_wall_s(log, "Solver"),
                   overall_wall_s=_wall_s(log, "Overall"),
                   device_loop="Step control: device loop" in log,
                   files=sorted(f for f in os.listdir(out)
                                if f.endswith(".ncd")),
                   launches=launches)
        if stats:
            res["stats"] = series_statistics(out, device=dev)
        if keep:
            shutil.copy(os.path.join(out, keep[0]), keep[1])
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
        shutil.rmtree(out, ignore_errors=True)
    res["counts"] = {int(k): (int(a), int(b))
                     for k, a, b in SNAPSHOT_DONE.findall(log)}
    last = res["counts"].get(max(res["counts"], default=0), (0, 0))
    res["ms_per_attempt"] = (1e3 * res["solver_wall_s"] / last[1]
                             if res["solver_wall_s"] and last[1] else None)
    if rc != 0 or not res["device_loop"]:
        raise AssertionError(f"{label}: rc {rc}, device loop "
                             f"{res['device_loop']}:\n{log[-2000:]}")
    return res


def _hr_app(dev) -> dict:
    """The app on the HR GradP case (f32) to t = HR_APP_FINAL_TIME:
    snapshots 0 and 1 through the device loop, every attempt through the
    delta path's kernels (whole blocks and the capture's idle attempt),
    and snapshot 1 read back through load_checkpoint (the HR geometry,
    finite fields at the run's t)."""
    from porousfreezethaw_tpu_torch.io.snapshots import load_checkpoint
    from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK

    text = golden_text("Params-LR-GradP", HR_GRID_NODES) + (
        f"final_time {HR_APP_FINAL_TIME}\nsaved_files 2\n")
    back = tempfile.mkdtemp(prefix="pft_chip_smoke_hr_ck_")
    try:
        res = _app_series(dev, "hr", "hr_app", text,
                          keep=("image.001.ncd", back))
        t0 = time.perf_counter()
        ck = load_checkpoint(os.path.join(back, "image.001.ncd"))
        load_s = time.perf_counter() - t0
        fields = np.asarray(ck.fields)
        finite = bool(np.isfinite(fields).all())
    finally:
        shutil.rmtree(back, ignore_errors=True)
    steps, attempts = res["counts"][1]
    m = _path_attempts(res["launches"], "delta", True)
    res.update(steps=steps, attempts=attempts, attempt_launches=m,
               checkpoint=dict(dims=list(ck.geom_dims), t=ck.t,
                               snapshot=ck.snapshot,
                               shape=list(fields.shape), finite=finite,
                               load_s=load_s))
    emit("hr_app", **res)
    if (res["files"] != ["image.000.ncd", "image.001.ncd"]
            or list(ck.geom_dims) != [HR_SHAPE[2], HR_SHAPE[1], HR_SHAPE[0]]
            or list(fields.shape) != [3, *HR_SHAPE] or not finite
            or ck.snapshot != 1 or abs(ck.t - HR_APP_FINAL_TIME) > 1e-9
            or m < attempts or (m - 1) % BLOCK):
        raise AssertionError(f"hr app: {res}")
    return res


def phase_hr(dev) -> dict:
    """HR (200 x 200 x 400, 16.0 M cells) on every single-device path:
    K1, K2, K2' and K4 against their plain versions and their device ms
    beside the bound (_hr_kernels); the bench's HR rows through the device
    loop (_hr_bench_row: the delta path in calc modes 0 and 2, the
    compensated commit, the classic stage, the double-buffered attempt and
    the f64 plain path) with ms/attempt, device ms, busy share, capture
    time and memory peak; the delta path's two loops bit for bit
    (_hr_loops); the app on the HR GradP Params (_hr_app)."""
    from porousfreezethaw_tpu_torch import bench

    out = dict(kernels=_hr_kernels(dev))
    trace_root = tempfile.mkdtemp(prefix="pft_chip_smoke_hr_trace_")
    own = bench.freezing_case
    # each case is built once (the rows' two bench runs share it)
    bench.freezing_case = functools.lru_cache(maxsize=3)(own)
    try:
        out["bench"] = [_hr_bench_row(dev, *row, trace_root)
                        for row in HR_ROWS]
        _release()
        out["loops"] = _hr_loops(dev)
    finally:
        bench.freezing_case = own
        shutil.rmtree(trace_root, ignore_errors=True)
    _release()
    out["app"] = _hr_app(dev)
    _release()
    return out


# The band of a full-length run (PERF.md section 2): at each recorded
# snapshot k, 0.95 min(ref_k, jax_k) <= port_k <= 1.05 max(ref_k, jax_k),
# ref the C reference's cumulative count and jax the JAX package's f32
# delta run on the TPU (VALIDATION.md), for steps and, where recorded,
# attempts.  {snapshot: (reference, JAX)}:
# VALIDATION.md:113-127, LR GradP
LR_GRADP_STEPS = {25: (152705, 162826), 50: (453391, 488292),
                  75: (627626, 675220), 99: (706966, 757550)}
LR_GRADP_ATTEMPTS = {99: (870988, 836257)}
# VALIDATION.md:61-80 and 148-158, LR Temp: the JAX run's counts at 25, 50
# and 75 are given only as the reference's times 1.030 +- 0.002; the low
# end, 1.028, gives the narrower band
LR_TEMP_STEPS = {k: (ref, round(1.028 * ref)) for k, ref in
                 TEMP_FULL_STEPS.items() if k != 99}
LR_TEMP_STEPS[99] = (288134, 296478)
LR_TEMP_ATTEMPTS = {99: (355469, 355232)}
# VALIDATION.md:166-192, MR GradP
MR_GRADP_STEPS = {1: (14865, 15647), 10: (150494, 160611),
                  25: (452166, 510735), 50: (1028833, 1199046),
                  60: (1198380, 1381148), 75: (1423133, 1618449),
                  99: (1683846, 1892442)}
MR_GRADP_ATTEMPTS = {99: (2073396, 1985347)}
# VALIDATION.md:250-261, HR Temp (the shipped Cases-HR Params)
HR_TEMP_STEPS = {1: (33406, 33662), 2: (92284, 95976)}
HR_TEMP_ATTEMPTS = {1: (41201, 37568), 2: (113831, 108371)}
# the snapshot of the resumed LR GradP run's checkpoint
RESUME_AT = 50


def band_misses(counts, steps, attempts=None) -> list:
    """The snapshots and counts of ``counts`` ({k: (steps, attempts)}, the
    port's) outside the band of their records ({k: (reference, JAX)}): a
    list of (k, what, port, low, high); a missing snapshot is a miss."""
    misses = []
    for what, recs, i in (("steps", steps, 0), ("attempts", attempts or {},
                                                 1)):
        for k, (ref, jax) in sorted(recs.items()):
            lo, hi = 0.95 * min(ref, jax), 1.05 * max(ref, jax)
            got = counts.get(k, (None, None))[i]
            if got is None or not lo <= got <= hi:
                misses.append((k, what, got, lo, hi))
    return misses


def _band_row(res, steps, attempts=None) -> dict:
    """A run's counts beside their records and the band."""
    keys = sorted(set(steps) | set(attempts or {}))
    return {str(k): dict(port=res["counts"].get(k),
                         reference_steps=steps.get(k, (None,))[0],
                         jax_steps=steps.get(k, (None, None))[1],
                         reference_attempts=(attempts or {}).get(
                             k, (None,))[0],
                         jax_attempts=(attempts or {}).get(
                             k, (None, None))[1]) for k in keys}


def phase_lr_f32_full(dev) -> dict:
    """Optional: the shipped LR GradP and LR Temp cases (tests/golden, f32,
    the increment form, 10 h, 100 snapshots) through the app's device
    loop, each held to the band at every recorded snapshot (steps and
    attempts: LR_GRADP_*, LR_TEMP_*); the Temp run's ice fraction peaking
    at TEMP_ICE_PEAK and ending at TEMP_ICE_END (t = 36000 s), each within
    1e-3 (VALIDATION.md:78-80); then GradP resumed by continue_series from
    the uninterrupted run's snapshot RESUME_AT (the checkpoint a run
    stopped there writes) to 99: its cumulative counts (RESUME_AT's plus
    the continuation's) in the band, and their difference from the
    uninterrupted run's (not bitwise: the f32 resume re-shifts u - u*)."""
    ck_dir = tempfile.mkdtemp(prefix="pft_chip_smoke_lr_ck_")
    ck = os.path.join(ck_dir, f"image.{RESUME_AT:03d}.ncd")
    try:
        gradp = _app_series(dev, "lr_f32_full", "lr_gradp",
                            golden_text("Params-LR-GradP"),
                            keep=(os.path.basename(ck), ck_dir))
        temp = _app_series(dev, "lr_f32_full", "lr_temp",
                           golden_text("Params-LR-Temp"), stats=True)
        resumed = _app_series(
            dev, "lr_f32_full", "lr_gradp_resumed",
            golden_text("Params-LR-GradP")
            + f"set icond_file = {ck}\nset continue_series\n")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    base = gradp["counts"][RESUME_AT]
    cumulative = {k: (base[0] + s, base[1] + a)
                  for k, (s, a) in resumed["counts"].items()
                  if k > RESUME_AT}
    ice, t = temp["stats"]["ice_fraction"], temp["stats"]["t"]
    rec = dict(
        gradp=dict(band=_band_row(gradp, LR_GRADP_STEPS, LR_GRADP_ATTEMPTS),
                   solver_wall_s=gradp["solver_wall_s"],
                   ms_per_attempt=gradp["ms_per_attempt"],
                   misses=band_misses(gradp["counts"], LR_GRADP_STEPS,
                                      LR_GRADP_ATTEMPTS)),
        temp=dict(band=_band_row(temp, LR_TEMP_STEPS, LR_TEMP_ATTEMPTS),
                  solver_wall_s=temp["solver_wall_s"],
                  ms_per_attempt=temp["ms_per_attempt"],
                  misses=band_misses(temp["counts"], LR_TEMP_STEPS,
                                     LR_TEMP_ATTEMPTS),
                  snapshots=len(ice), ice_peak=max(ice) if ice else None,
                  ice_peak_t=t[int(np.argmax(ice))] if ice else None,
                  ice_end=ice[-1] if ice else None,
                  t_end=t[-1] if ice else None,
                  reference_ice=[TEMP_ICE_PEAK, TEMP_ICE_END]),
        resumed=dict(
            first_snapshot=min(resumed["counts"], default=None),
            cumulative={str(k): c for k, c in cumulative.items()
                        if k in LR_GRADP_STEPS},
            minus_uninterrupted={
                str(k): [c[0] - gradp["counts"][k][0],
                         c[1] - gradp["counts"][k][1]]
                for k, c in cumulative.items() if k in LR_GRADP_STEPS},
            misses=band_misses(cumulative, {
                k: r for k, r in LR_GRADP_STEPS.items() if k > RESUME_AT},
                LR_GRADP_ATTEMPTS)))
    emit("lr_f32_full", **rec)
    bad = dict(gradp=rec["gradp"]["misses"], temp=rec["temp"]["misses"],
               resumed=rec["resumed"]["misses"])
    if (any(bad.values()) or len(ice) != 100
            or abs(rec["temp"]["ice_peak"] - TEMP_ICE_PEAK) > 1e-3
            or abs(rec["temp"]["ice_end"] - TEMP_ICE_END) > 1e-3
            or abs(rec["temp"]["t_end"] - 36000.0) > 1e-3
            or rec["resumed"]["first_snapshot"] != RESUME_AT):
        raise AssertionError(f"lr_f32_full: {bad}, {rec}")
    return rec


def _band_phase(dev, phase, text, steps, attempts) -> dict:
    """A full-length f32 run through the app's device loop held to the
    band at every recorded snapshot."""
    res = _app_series(dev, phase, phase, text)
    rec = dict(band=_band_row(res, steps, attempts),
               solver_wall_s=res["solver_wall_s"],
               overall_wall_s=res["overall_wall_s"],
               ms_per_attempt=res["ms_per_attempt"],
               misses=band_misses(res["counts"], steps, attempts))
    emit(phase, **rec)
    if rec["misses"]:
        raise AssertionError(f"{phase}: outside the band: {rec['misses']}")
    return rec


def phase_mr_gradp_full(dev) -> dict:
    """Optional: MR GradP (cases.freezing_params_text(200, 0), the
    published PhysRevE constants) in f32 to snapshot 99 through the app's
    device loop, in the band of MR_GRADP_* at every recorded snapshot."""
    from porousfreezethaw_tpu_torch.cases import freezing_params_text
    text = freezing_params_text(200, 0) + (
        "\nset ball_positions_file = "
        + os.path.join(REPO, "data", "spheres_positions.txt") + "\n")
    return _band_phase(dev, "mr_gradp_full", text, MR_GRADP_STEPS,
                       MR_GRADP_ATTEMPTS)


def phase_hr_full(dev) -> dict:
    """Optional: HR Temp (the LR Temp golden at grid_nodes 400, f32) to
    snapshot 2 through the app's device loop, in the band of HR_TEMP_* at
    snapshots 1 and 2."""
    return _band_phase(dev, "hr_full",
                       golden_text("Params-LR-Temp", HR_GRID_NODES, 2),
                       HR_TEMP_STEPS, HR_TEMP_ATTEMPTS)


# an earlier record of the settle through the app's host loop on the card,
# from before the controllers took the growth power from pow_02: its
# steps, attempts and eps_s (phase dem_settle_host runs today's)
SETTLE_HOST_LOOP = (183469, 221608, 0.64996)
# the settle's first snapshots, through the first contacts (from t = 0.48)
SETTLE_PREFIX = 32


def _settle_prefix(dev) -> dict:
    """The settle's first SETTLE_PREFIX snapshot targets, solved as the app
    solves them (solve_guarded to each target in turn), through the device
    loop and the host loop on the card: the counts at every target and
    the state at the last bit for bit; each loop's wall (the graph's
    capture inside the device loop's)."""
    from porousfreezethaw_tpu_torch.models.dem import (
        DEMAttempt, DEMConfig, icond_dense, make_dem_rhs, solve_guarded)
    from porousfreezethaw_tpu_torch.ops.cuda import build
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init)

    # the kernels are built at first use: without phase build, that would
    # fall inside the device loop's wall
    build.load_library()
    cfg = DEMConfig(variant="friction_angular", n=200, T=8.0,
                    snapshots=400)
    y0, _ = icond_dense(cfg, seed=0)
    rhs = make_dem_rhs(cfg, dtype=torch.float64, device=dev)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min)
    runs = {}
    for loop, solver in (("device", DEMAttempt(rhs)), ("host", rhs)):
        st = merson_init({k: torch.as_tensor(v, device=dev)
                          for k, v in y0.items()}, 0.0, cfg.ht)
        counts = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for snap in range(SETTLE_PREFIX):
            st, status, _ = solve_guarded(
                solver, st, (cfg.T / (cfg.snapshots - 1)) * snap, params)
            counts.append((st.steps, st.steps_total, status))
        torch.cuda.synchronize()
        runs[loop] = (st, counts, time.perf_counter() - t0)
    (a, ca, wa), (b, cb, wb) = runs["device"], runs["host"]
    n = a.steps_total
    rec = dict(snapshots=SETTLE_PREFIX, t=a.t, steps=a.steps, attempts=n,
               counts_equal=ca == cb,
               state_bitwise=(a.t, a.h) == (b.t, b.h) and all(
                   torch.equal(a.y[k], b.y[k]) for k in a.y),
               device_ms_per_attempt=1e3 * wa / n,
               host_ms_per_attempt=1e3 * wb / b.steps_total,
               speedup=wb / wa)
    emit("dem_settle_prefix", **rec)
    if not (rec["counts_equal"] and rec["state_bitwise"]
            and all(c[2] == 0 for c in ca)):
        raise AssertionError(f"dem settle prefix: the loops differ: {rec}")
    return rec


def _settle_app(dev, name) -> dict:
    """VALIDATION.md's settle through the spheres app on the card (seed 0,
    --device-buffer 8) into chiprun_out/<name>: the app's rc and wall, the
    (steps, attempts) at every snapshot, the final positions (their text
    too) and the control and commit kernels' float64 launches."""
    import contextlib

    from porousfreezethaw_tpu_torch.apps import spheres
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

    out = os.path.join(REPO, "chiprun_out", name)
    os.makedirs(out, exist_ok=True)
    final = os.path.join(out, "spheres_final_positions.txt")
    log_path = os.path.join(out, "spheres.log")
    _reset_counters(st)
    t0 = time.perf_counter()
    # the app's console lines go to the log as they come, so that a run cut
    # short still shows how far it got
    with open(log_path, "w", buffering=1) as log, \
            contextlib.redirect_stdout(log):
        rc = spheres.main([
            "--variant", "friction_angular", "--n", "200", "--precision",
            "f64", "--icond", "dense", "--seed", "0", "--snapshots", "400",
            "--final-time", "8", "--device", str(dev), "--device-buffer",
            "8", "--output", os.path.join(out, "OUTPUT"),
            "--final-positions", final])
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    with open(final) as f:
        final_text = f.read()
    counts = [(int(a), int(b)) for a, b in
              re.findall(r"(\d+) R-K steps \((\d+) total\)", text)]
    return dict(rc=rc, wall_s=wall, counts=counts,
                pos=np.loadtxt(final), final_text=final_text,
                launched=_counters(st)["commit_f64"])


def phase_dem_settle(dev) -> dict:
    """Optional: VALIDATION.md's settle through the spheres app on the
    card (seed 0; the app's device loop, --device-buffer 8), its final
    positions, and their eps_s at res = 100 on the card, beside the
    repo's records: eps_s 0.6529 (JAX) and 0.6549 (the reference's run),
    ensemble 0.64-0.71; z-extent 0.078-1.340; JAX's 170,206 / 205,471
    steps; the app's host loop on the card, SETTLE_HOST_LOOP.  The control
    and commit counters give the attempts launched, and the idle ones
    among them (past each solve call's end) their share of the wall.
    First, the settle's first SETTLE_PREFIX snapshots through both loops
    bit for bit (_settle_prefix), whose counts the app's must equal.
    Returns the app's run (_settle_app)."""
    from porousfreezethaw_tpu_torch.analysis import eps_s

    prefix = _settle_prefix(dev)
    run = _settle_app(dev, "dem_settle")
    pos, counts = run["pos"], run["counts"]
    val = eps_s(pos, r=0.1, res=100, device=dev)
    steps, attempts = counts[-1]
    at_prefix = list(counts[SETTLE_PREFIX - 1])
    rec = dict(rc=run["rc"], wall_s=run["wall_s"], controller="device",
               counts_at_prefix=at_prefix, steps=steps, attempts=attempts,
               ms_per_attempt=1e3 * run["wall_s"] / attempts, eps_s=val,
               attempt_launches=run["launched"],
               idle_attempts=run["launched"] - attempts,
               z_extent=[float(pos[:, 2].min()), float(pos[:, 2].max())],
               records=dict(eps_s_jax=0.6529, eps_s_reference=0.6549,
                            ensemble=[0.64, 0.71],
                            z_extent_jax=[0.078, 1.340],
                            steps_jax=[170206, 205471],
                            host_loop=list(SETTLE_HOST_LOOP)))
    emit("dem_settle", **rec)
    if (run["rc"] != 0 or not 0.60 < val < 0.72
            or at_prefix != [prefix["steps"], prefix["attempts"]]):
        raise AssertionError(f"dem settle: {rec}")
    return run


def phase_dem_settle_host(dev, device_run=None) -> None:
    """Optional: the whole settle of phase dem_settle through the app's
    host loop on the card (``models.dem.attempt.uses_device_loop``
    patched to False): its counts, wall and eps_s.  When phase dem_settle
    ran in the same invocation (``device_run``), the two loops must give
    the same counts at every one of the 400 snapshots and the same final
    positions byte for byte."""
    from porousfreezethaw_tpu_torch.analysis import eps_s
    from porousfreezethaw_tpu_torch.models.dem import attempt as dem_attempt

    own = dem_attempt.uses_device_loop
    dem_attempt.uses_device_loop = lambda device, mesh: False
    try:
        run = _settle_app(dev, "dem_settle_host")
    finally:
        dem_attempt.uses_device_loop = own
    pos, counts = run["pos"], run["counts"]
    steps, attempts = counts[-1]
    rec = dict(rc=run["rc"], wall_s=run["wall_s"], controller="host",
               steps=steps, attempts=attempts,
               ms_per_attempt=1e3 * run["wall_s"] / attempts,
               eps_s=eps_s(pos, r=0.1, res=100, device=dev),
               attempt_launches=run["launched"],
               z_extent=[float(pos[:, 2].min()), float(pos[:, 2].max())],
               host_loop_record=list(SETTLE_HOST_LOOP))
    if device_run is not None:
        rec.update(device_loop=list(device_run["counts"][-1]),
                   device_wall_s=device_run["wall_s"],
                   counts_equal=counts == device_run["counts"],
                   final_positions_equal=(run["final_text"]
                                          == device_run["final_text"]),
                   speedup=run["wall_s"] / device_run["wall_s"])
    emit("dem_settle_host", **rec)
    if (run["rc"] != 0 or run["launched"] != 0 or len(counts) != 400
            or (device_run is not None
                and not (rec["counts_equal"]
                         and rec["final_positions_equal"]))):
        raise AssertionError(f"dem settle, host loop: {rec}")


# --------------------------------------------------------------------------
# phase 9: the DEM cell list
# --------------------------------------------------------------------------

# cell_lanes against the dense term, per leaf relative to max|dense|: f64
# as tests/test_dem_celllist.py holds JAX's; f32 as the card's f32 against
# the CPU's (the two sum the neighbours in other orders)
CELL_TOL_F64, CELL_TOL_F32 = 1e-12, DEM_F32_TOL
# the bench's capacity of the cell rows, and the larger beds' checks
CELL_K = 8
CELL_SIZES = (4000, 6000, 10000, 20000)
# the beds whose cell_lanes RHS is held to dense: one card holds the dense
# (n, n, 3) f64 temporaries at 4000; at 20000 the oracle is sharded
CELL_CHECK_SIZES = (4000, 20000)
# (n, neighbor, capacity) of the bench rows, at reduced attempts
CELL_BENCH_ROWS = ((4000, "dense", 0), (4000, "cell_lanes", CELL_K),
                   (6000, "dense", 0), (6000, "cell_lanes", CELL_K),
                   (10000, "cell_lanes", CELL_K),
                   (20000, "cell_lanes", CELL_K))
CELL_BENCH_STEPS, CELL_BENCH_WARM = 60, 20


def _bed(n, seed=SEED, moving=True):
    """The bench's bed of n spheres (icond_dense, seed 0, the bench's
    radius) with random velocities and spins when ``moving``; its config."""
    from porousfreezethaw_tpu_torch.models.dem import DEMConfig, icond_dense
    r = 0.1 if n <= 400 else 0.1 * (200.0 / n) ** (1.0 / 3.0)
    cfg = DEMConfig(variant="friction_angular", n=n, r=r)
    y, _ = icond_dense(cfg, seed=0)
    if moving:
        rng = np.random.RandomState(seed)
        y["vel"] = 0.5 * rng.standard_normal((n, 3))
        y["angvel"] = rng.standard_normal((n, 3))
    return cfg, y


def _rel_errs(got, ref):
    return {k: float((got[k] - ref[k]).abs().max())
            / max(float(ref[k].abs().max()), 1e-300) for k in ref}


def _cells_rhs(dev) -> None:
    """cell_lanes (and cell_list) against the dense term on the card: the
    four variants at n = 200 (f64 and f32), n = 4000 (f64, dense), n =
    20000 (f64, against the dense term sharded over p20 virtual shards:
    one card holds no (n, n, 3) f64 temporary of 9.6 GB); the dense
    icond's occupancy at 4000-20000 within half the default capacity;
    the overflow's NaN."""
    from porousfreezethaw_tpu_torch.models.dem import (
        DEMConfig, make_cell_list, make_dem_rhs)
    from porousfreezethaw_tpu_torch.parallel import (
        gather_dem_state, make_mesh, shard_dem_state)

    def on_dev(y, dtype):
        return {k: torch.as_tensor(v, dtype=dtype, device=dev)
                for k, v in y.items()}

    cases = [(v, DEM_N, dtype, nb, 16) for v in DEM_VARIANTS
             for dtype in (torch.float64, torch.float32)
             for nb in ("cell_lanes", "cell_list")]
    cases += [("friction_angular", n, torch.float64, "cell_lanes", CELL_K)
              for n in CELL_CHECK_SIZES]
    for variant, n, dtype, nb, cap in cases:
        if n == DEM_N:
            cfg = DEMConfig(variant=variant, n=n)
            y = on_dev(_dem_state(cfg, SEED), dtype)
        else:
            cfg, y = _bed(n)
            y = on_dev(y, dtype)
        torch.cuda.reset_peak_memory_stats(dev)
        cells = make_dem_rhs(cfg, dtype=dtype, neighbor=nb,
                             cell_capacity=cap, device=dev)
        got = cells(0.0, y)
        torch.cuda.synchronize()
        cell_peak = torch.cuda.max_memory_allocated(dev) / 1e6
        if n <= CELL_CHECK_SIZES[0]:
            oracle = "dense"
            ref = make_dem_rhs(cfg, dtype=dtype, device=dev)(0.0, y)
        else:
            spec = f"p{n // 1000}"
            oracle = "dense on " + spec
            mesh = make_mesh(spec, [dev] * (n // 1000))
            ref = gather_dem_state(make_dem_rhs(cfg, dtype=dtype, mesh=mesh)(
                0.0, shard_dem_state(y, mesh)))
        tol = CELL_TOL_F64 if dtype == torch.float64 else CELL_TOL_F32
        errs = _rel_errs(got, ref)
        row = dict(variant=variant, n=n, dtype=str(dtype)[6:], neighbor=nb,
                   capacity=cap, oracle=oracle, tol=tol, max_rel_err=errs,
                   occupancy=cells.neighbor_struct.cell_occupancy(y["pos"]),
                   cell_peak_memory_mb=cell_peak)
        emit("dem_cells_rhs", **row)
        bad = {k: e for k, e in errs.items() if not e <= tol}
        if bad:
            raise AssertionError(f"dem cells rhs {row}: {bad} above {tol}")
    occ = {}
    for n in CELL_SIZES:
        cfg, y = _bed(n, moving=False)
        occ[n] = make_cell_list(cfg, device=dev).cell_occupancy(y["pos"])
    emit("dem_cells_occupancy", capacity=16, occupancy=occ)
    if max(occ.values()) > 8:
        raise AssertionError(f"dense icond occupancy {occ} above 8")
    cfg = DEMConfig(variant="friction_angular", n=12, r=0.1)
    rng = np.random.RandomState(0)
    y = on_dev({"pos": 0.15 + 0.01 * rng.random_sample((12, 3)),
                "vel": rng.standard_normal((12, 3)),
                "angvel": rng.standard_normal((12, 3))}, torch.float64)
    rhs = make_dem_rhs(cfg, neighbor="cell_lanes", cell_capacity=8,
                       device=dev)
    out = rhs(0.0, y)
    poisoned = bool(out["vel"].isnan().all() and out["angvel"].isnan().all())
    emit("dem_cells_overflow", n=12, capacity=8,
         occupancy=rhs.neighbor_struct.cell_occupancy(y["pos"]),
         nan=poisoned)
    if not poisoned:
        raise AssertionError("cell_lanes overflow did not poison with NaN")


def _cells_short_solve(dev, short) -> None:
    """The short f64 solve of phase dem with cell_lanes, through the device
    loop: its end state within DEM_STATE_TOL of the dense one's
    (``short``, the card's) per leaf; the counts beside dense's; the wall
    of a second run, after the first's capture."""
    from porousfreezethaw_tpu_torch.models.dem import (
        DEMAttempt, DEMConfig, icond_dense, make_dem_rhs)
    from porousfreezethaw_tpu_torch.solvers.merson import (
        MersonParams, merson_init, merson_solve_device)

    cfg = DEMConfig(variant="friction_angular", n=DEM_N)
    y0, _ = icond_dense(cfg, seed=0)
    att = DEMAttempt(make_dem_rhs(cfg, neighbor="cell_lanes", device=dev))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, status = merson_solve_device(
            merson_init({k: torch.as_tensor(v, device=dev)
                         for k, v in y0.items()}, 0.0, cfg.ht),
            DEM_SHORT_T, MersonParams(delta=cfg.delta, h_min=cfg.ht_min),
            att)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rel = _rel_errs(st.y, short["state"])
    rec = dict(neighbor="cell_lanes", n=DEM_N, dtype="f64", t=st.t,
               controller="device", steps=st.steps, attempts=st.steps_total,
               graph_capture_s=att.device_loop(dev).capture_s,
               dense=[short["steps"], short["attempts"]],
               max_rel_state_diff=rel, state_tol=DEM_STATE_TOL,
               ms_per_attempt=1e3 * wall / st.steps_total,
               dense_ms_per_attempt=short["ms_per_attempt"])
    emit("dem_cells_solve", **rec)
    bad = {k: e for k, e in rel.items() if not e <= DEM_STATE_TOL}
    if status != 0 or bad:
        raise AssertionError(f"cell_lanes short solve: {rec}")


def _cells_bench(dev) -> list:
    """The bench's DEM rows at 4000-20000 (dense and cell_lanes, f32) at
    reduced attempts, through the device loop: ms/attempt
    (bench.bench_dem), the graph's capture time, peak memory (the graph's
    pool included), and device ms and launches per attempt
    (_block_profile)."""
    from porousfreezethaw_tpu_torch import bench

    recs = []
    for n, nb, cap in CELL_BENCH_ROWS:
        args = bench.parse_args([
            "--suite", "dem", "--device", str(dev), "--steps",
            str(CELL_BENCH_STEPS), "--warm-steps", str(CELL_BENCH_WARM)])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        rec = bench.bench_dem(args, n_spheres=n, neighbor=nb,
                              cell_capacity=cap or None)
        rec["peak_memory_mb"] = torch.cuda.max_memory_allocated(dev) / 1e6
        rec.update(_block_profile(dev, n, nb, cap),
                   label=f"dem_{n}_{nb}" + (f"_k{cap}" if cap else ""))
        emit("dem_cells_bench", **rec)
        suffix = "_celllanes" if nb == "cell_lanes" else ""
        if not (rec["value"] > 0 and rec["metric"]
                == f"dem_{n}{suffix}_particle_rhs_evals_per_s"
                and rec["controller"] == "device"):
            raise AssertionError(f"dem cells bench row {n} {nb}: {rec}")
        recs.append(rec)
    return recs


def phase_dem_cells(dev, short=None) -> None:
    """The DEM cell list on the card: its right-hand side against the
    dense term up to n = 20000, the occupancy and the overflow guard, the
    short solve against dense's (``short``, phase dem's record, or run
    here), the bench's cell rows beside dense."""
    _cells_rhs(dev)
    _cells_short_solve(dev, short or _dem_short_solve(dev))
    _cells_bench(dev)


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
    temp_f64 = short = None
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels.update(phase_kernels(dev))
    if "solve" in phases:
        phase_solve(dev)
    idle_ms = None
    if "controller" in phases:
        ctrl = phase_controller(dev)
        idle_ms = next(r["idle_attempt_ms"] for r in ctrl["f64"]
                       if r["case"] == "lr_temp")
    if "bench" in phases:
        launches["fused_attempt"] = phase_bench(dev)["fused_attempt"]
    if "app" in phases:
        app_launches, temp_f64 = phase_app(dev, idle_ms)
        launches.update(app_launches)
    if "mesh" in phases:
        mesh_kernels, mesh_launches = phase_mesh(dev, temp_f64)
        kernels.update(mesh_kernels)
        launches.update(mesh_launches)
    if "dem" in phases:
        short = phase_dem(dev)
        launches.update(short["launches"])
    if "dem_cells" in phases:
        phase_dem_cells(dev, short)
    if "hr" in phases:
        phase_hr(dev)
    if "profile" in phases:
        phase_profile(dev)
    settle = None
    if "dem_settle" in phases:
        settle = phase_dem_settle(dev)
    if "dem_settle_host" in phases:
        phase_dem_settle_host(dev, settle)
    if "tracing" in phases:
        phase_tracing(dev)
    for name, run in (("temp_f64_full", phase_temp_f64_full),
                      ("lr_f32_full", phase_lr_f32_full),
                      ("mr_gradp_full", phase_mr_gradp_full),
                      ("hr_full", phase_hr_full)):
        if name in phases:
            run(dev)

    for name in set(kernels) & set(launches):
        kernels[name]["launches"] = launches[name]
        # the order of the kernel work: main-path launches times the
        # card's time above the bound, in ms
        kernels[name]["launches_x_gap_ms"] = launches[name] * (
            kernels[name]["device_ms"] - kernels[name]["bound_ms"])
    if not set(PHASES) <= set(phases):
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
