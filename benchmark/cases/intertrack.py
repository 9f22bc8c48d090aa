"""The intertrack freezing solve of one cell, set up through the program's
own modules as ``apps/intertrack.py`` ``run_iteration`` sets up a
single-device run: the Params text parsed, the parameters and the grid,
the formula initial condition, the glass field of the ball file, the
float32 shift of the temperature origin, the attempt object of the app's
rule (its lines 296-353) and the step-control parameters.

Only this module imports the program.  It writes nothing: no log, no
snapshot.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from porousfreezethaw_tpu_torch.apps.intertrack import (
    kernels_apply, service_chunk)
from porousfreezethaw_tpu_torch.config.params import parse_param_file
from porousfreezethaw_tpu_torch.core.device import field_dtype, numpy_dtype
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing.attempt import PlainAttempt
from porousfreezethaw_tpu_torch.models.freezing.equation import (
    make_noise_field, make_rhs)
from porousfreezethaw_tpu_torch.models.freezing.glass import (
    build_glass_field, read_ball_positions)
from porousfreezethaw_tpu_torch.models.freezing.icond import (
    build_initial_conditions)
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    PARAM_INFO, FreezingParams, shift_temperature_origin)
from porousfreezethaw_tpu_torch.ops.cuda.stencil import (
    DeltaAttempt, DeltaAttemptComp, StageAttempt)
from porousfreezethaw_tpu_torch.solvers import merson


@dataclasses.dataclass
class Case:
    """A solve ready to run: ``y0`` the program's state at t = 0 on the
    device (float32 states hold u - ``u_shift``), ``attempt`` the object
    that the device loop drives, ``mparams`` its step control."""

    y0: torch.Tensor
    u_shift: float
    attempt: Any
    path: str
    mparams: Any
    tau: float
    final_time: float
    cells: int
    dtype: torch.dtype
    chunk: int
    build_s: float


def params_text(cfg: dict, traffic: dict, bed_file: str, read_text,
                extra: str = "") -> str:
    """The Params text the program reads: the configuration's frozen text,
    then the traffic mix's settings, ``extra`` and the ball file (later
    definitions win, as in any Params file)."""
    lines = [read_text(cfg["params_text"])]
    for name, value in traffic.get("params", {}).items():
        lines.append(f"{name} {value!r}")
    lines.append(extra)
    lines.append(f"set ball_positions_file = '{bed_file}'")
    return "\n".join(lines) + "\n"


def build(text: str, precision: str, device: torch.device,
          workdir: str) -> Case:
    """Set up the solve of ``text`` in ``precision`` on ``device``."""
    t0 = time.perf_counter()
    pf = parse_param_file(text, env={"OUTPUT": workdir})
    params = FreezingParams.from_dict(
        {name: pf.get(name) for name, _ in PARAM_INFO if name})
    calc_mode = pf.get_int("calc_mode", 0)
    geom = GridGeometry(pf.get("L1"), pf.get("L2"), pf.get("L3"),
                        pf.get_int("n1"), pf.get_int("n2"), pf.get_int("n3"))
    dtype = field_dtype(precision)
    np_dtype = numpy_dtype(dtype)
    w0 = build_initial_conditions(geom, params, pf.icond_formulas,
                                  dtype=np_dtype)
    noise = make_noise_field(geom, params, 0, dtype=np_dtype)
    balls = read_ball_positions(pf.setting("ball_positions_file"), params)
    w0 = np.asarray(w0, dtype=np_dtype)
    w0[2] = build_glass_field(geom, params, balls, w0[2])

    f32 = dtype == torch.float32
    u_shift = params.u_star if f32 else 0.0
    solver_params = (shift_temperature_origin(params, u_shift)
                     if u_shift else params)
    if u_shift:
        w0[0] -= u_shift

    # the app's choice of attempt (apps/intertrack.py, the single-device
    # branch): the increment form by default, its compensated commit on
    # request, the classic stage kernel under increment_form 0; the plain
    # right-hand side where the kernels do not apply (f64, noise)
    use_delta = bool(pf.vars.get("increment_form", 1.0))
    use_comp = bool(pf.vars.get("compensated_commit", 0.0))
    attempt_fn = None
    if kernels_apply(dtype, noise):
        if use_delta:
            cls = DeltaAttemptComp if use_comp else DeltaAttempt
            attempt_fn = attempt = cls(geom, solver_params, calc_mode)
        else:
            attempt = StageAttempt(geom, solver_params, calc_mode)
    else:
        rhs = make_rhs(geom, solver_params, calc_mode, device, noise=noise)
        attempt = PlainAttempt(rhs, geom.shape, dtype)
    default_growth = 1.05 if f32 and attempt_fn is None else 0.0
    mparams = merson.MersonParams(
        delta=pf.get("delta"), h_min=pf.get("tau_min", 0.0),
        accept_growth_min=float(pf.vars.get("accept_growth_min",
                                            default_growth)),
        handle_nan=bool(pf.vars.get("handle_nan", f32)))

    y0 = torch.as_tensor(np.ascontiguousarray(w0)).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Case(y0=y0, u_shift=u_shift, attempt=attempt,
                path=type(attempt).__name__, mparams=mparams,
                tau=pf.get("tau"), final_time=pf.get("final_time"),
                cells=geom.num_cells, dtype=dtype, chunk=service_chunk(),
                build_s=time.perf_counter() - t0)


def solve(case: Case, y, t: float, h: float, attempts: int, between=None):
    """``merson_solve_device`` from (y, t, h) on the case's attempt object
    in calls of ``attempts`` attempts recording their trace, as the app's
    chunks do: (state, status)."""
    prm = dataclasses.replace(case.mparams, max_steps=attempts,
                              record_trace=attempts)
    st = merson.MersonState(t=t, h=h, y=y, steps=0, steps_total=0)
    st, status, _ = merson.merson_solve_device(st, case.final_time, prm,
                                               case.attempt, between=between)
    return st, status


def device_loop(case: Case, device: torch.device):
    return case.attempt.device_loop(device)


def counters():
    """The program's launch counters: (kernel name in a trace, [(object,
    attribute), ...]) for each of its own kernels."""
    from porousfreezethaw_tpu_torch.ops.cuda import control as ctl
    from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
    return [
        ("fused_stage_kernel", [(st.fused_stage, "launches"),
                                (st.fused_stage_shard, "launches"),
                                (st.fused_stage_shard, "launches_split")]),
        ("delta_g_kernel", [(st.delta_g, "launches"),
                            (st.delta_g, "launches_dy"),
                            (st.delta_g_shard, "launches"),
                            (st.delta_g_shard, "launches_dy")]),
        ("fused_attempt_kernel", [(st.fused_attempt, "launches")]),
        ("merson_control_kernel", [(ctl.merson_control, "launches"),
                                   (ctl.merson_control, "launches_f64")]),
        ("commit_kernel", [(ctl.commit, "launches"),
                           (ctl.commit, "launches_f64")]),
    ]
