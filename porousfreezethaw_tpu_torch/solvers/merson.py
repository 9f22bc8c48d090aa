"""Adaptive Runge-Kutta-Merson time integrator (PyTorch).

The counterpart of ``porousfreezethaw_tpu/solvers/merson.py``, itself a
re-design of the reference solver family ``modules/RK_Asolver`` /
``RK_MPI_SAsolver``.  Numerics replicated exactly (RK_Asolver.c:202-294,
RK_MPI_SAsolver.c:330-660):

    K1 = f(t,       x)
    K2 = f(t+h/3,   x + (h/3) K1)
    K3 = f(t+h/3,   x + (h/6)(K1+K2))
    K4 = f(t+h/2,   x + (h/8)(K1+3 K3))
    K5 = f(t+h,     x + h (0.5 K1 - 1.5 K3 + 2 K4))
    eps   = max |0.2 K1 - 0.9 K3 + 0.8 K4 - 0.1 K5| * eps_mult   (max norm)
    eps  *= |h/3|                 if delta_mode == 'local'
    new_h = 0.8 (delta/eps)^0.2 h  (eps>0);  2 h if eps == 0
    accept iff eps < delta or |h| < h_min
    update  x += (h/3) ((K1+K5)/2 + 2 K4);  t += h
    NaN backoff (opt-in): h /= 10, abort when h/(T-t) < 1e-11
    final-step trimming: h clamped to final_time - t; the *untrimmed*
      estimate is preserved for seamless continuation across calls

The state ``y`` is one tensor.  The controller scalars t, h and eps are
Python floats (f64) whatever the field dtype: f32 time accumulation breaks
down over the reference's 36000 s runs (ulp(36000) in f32 is ~4 ms vs
steps ~20 ms).  The accept/reject loop runs on the host and reads eps back
with one device sync per attempt; the service callback is a plain Python
call after each accepted step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

# status codes (mirroring the reference return codes where they exist)
OK = 0            # reached final_time
INTERRUPTED = 1   # service callback requested a break (RKA_CMD_BREAK)
NAN_ABORT = -4    # NaN backoff failed (reference -4)
MAX_STEPS = -7    # safety bound hit (no reference analog: the C solver loops forever)


class MersonState(NamedTuple):
    """Integration state carried across ``merson_solve`` calls — the
    RK_MPI_S_SOLUTION fields t / h / steps / steps_total
    (include/RK_MPI_SAsolver.h:196-289)."""

    t: float
    h: float
    y: Any                 # solution tensor
    steps: int             # successful steps
    steps_total: int       # attempted steps


@dataclasses.dataclass(frozen=True)
class MersonParams:
    """Step-control parameters (RK_MPI_S_SOLUTION: h_min, delta, delta_mode)."""

    delta: float
    h_min: float = 0.0
    delta_mode: str = "global"     # 'global' (both reference apps) or 'local'
    handle_nan: bool = False
    max_steps: int = 2**62         # safety bound on attempted steps per call
    record_trace: int = 0          # record (t, h) of up to N accepted steps
    accept_growth_min: float = 0.0  # if > 1: minimum h-growth factor on
                                   # ACCEPTED steps — the f32 noise-floor
                                   # escape of the classic stage path (the
                                   # growth rule's fixed point is eps =
                                   # 0.328*delta; an h-independent
                                   # estimator floor there pins h).  Off
                                   # (0.0) for f64 and for the increment
                                   # form: exact reference step sequences.


def merson_init(y0, t0: float = 0.0, h0: float = 1.0) -> MersonState:
    return MersonState(t=float(t0), h=float(h0), y=y0, steps=0,
                       steps_total=0)


def _axpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + a*x with the f64 scalar rounded to the field dtype first, so
    controller scalars never upcast f32 fields."""
    return y + torch.tensor(a, dtype=x.dtype, device=x.device) * x


def merson_solve(
    rhs: Optional[Callable[[float, torch.Tensor], torch.Tensor]],
    state: MersonState,
    final_time: float,
    params: MersonParams,
    eps_mult: Optional[torch.Tensor] = None,
    service_callback: Optional[Callable[[float, float, int], int]] = None,
    stage_fn: Optional[Callable] = None,
    attempt_fn: Optional[Any] = None,
):
    """Integrate ``state`` to ``final_time``; returns ``(state, status)``,
    or ``(state, status, (t_trace, h_trace))`` with ``record_trace``.

    ``rhs(t, y) -> dy/dt``.  ``eps_mult`` is an optional tensor of per-cell
    error multipliers broadcast against ``y`` (chunk_eps_mult).

    ``service_callback(t, h, steps) -> int`` is called after every
    accepted step; a nonzero return interrupts the solve, which then
    returns ``status == INTERRUPTED`` with a valid continuation ``h``
    (RK_MPI_SAsolver.c:578-601).

    ``stage_fn(t_stage, h, y, [(c_i, K_i), ...]) -> K`` optionally replaces
    the default stage evaluation ``rhs(t_stage, y + h*sum(c_i K_i))``.  If
    it has a ``.stage5`` attribute (the fused Merson tail returning
    ``(y_spec, eps_blocks)``), error and speculative update come from it
    whenever ``eps_mult`` is None; ``.commit(y, y_spec, accept)`` writes a
    partial-state ``y_spec`` back into ``y``.

    ``attempt_fn`` subsumes ``stage_fn``: ``pack(y)`` once per call,
    ``attempt(t, h, y) -> (carry_spec, eps_blocks)`` per attempt,
    ``commit(carry_spec, accept) -> y`` and ``unpack(y)`` at the end.
    ``eps_mult`` is unsupported with it.
    """
    tf = float(final_time)
    delta = float(params.delta)
    h_min = float(params.h_min)
    local_mode = params.delta_mode == "local"

    t0, h0 = float(state.t), float(state.h)

    # --- prologue: reverse h toward final_time; pre-truncate the first step
    # (RK_MPI_SAsolver.c:300-307) ---
    h_rev = -h0 if ((tf > t0 and h0 < 0) or (tf < t0 and h0 > 0)) else h0
    prefinished = (h_rev == 0) or (abs(tf - t0) <= abs(h_rev))
    h = tf - t0 if prefinished else h_rev
    # continuation h: stays at the (reversed) input value unless a
    # NEXTFINISH saves a fresh untrimmed estimate
    h_cont = h_rev

    if attempt_fn is not None and eps_mult is not None:
        raise ValueError("eps_mult is not supported with attempt_fn")
    stage5_fn = getattr(stage_fn, "stage5", None) if eps_mult is None else None
    commit_fn = getattr(stage_fn, "commit", None)
    if getattr(stage_fn, "k_partial", False) and stage5_fn is None:
        raise ValueError(
            "this stage_fn emits partial-state K arrays and requires its "
            ".stage5 tail (eps_mult is unsupported with it)")

    def eps_of(K1, K3, K4, K5):
        err = torch.abs(0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5)
        if eps_mult is not None:
            err = eps_mult * err
        return torch.amax(err)

    n_trace = params.record_trace
    t_tr = [0.0] * n_trace
    h_tr = [0.0] * n_trace

    t = t0
    if attempt_fn is not None:
        y = attempt_fn.pack(state.y)
    elif commit_fn is not None:
        # commit_fn updates the state in place; a list is a sharded state
        y = ([s.clone() for s in state.y] if isinstance(state.y, list)
             else state.y.clone())
    else:
        y = state.y
    steps, steps_total = int(state.steps), int(state.steps_total)
    start_total = steps_total
    finished = prefinished
    done = False
    status = OK

    while not done and steps_total - start_total < params.max_steps:
        h2, h3, h6, h8 = h / 2, h / 3, h / 6, h / 8

        y_spec = None
        carry_spec = None
        if attempt_fn is not None:
            carry_spec, eps_blocks = attempt_fn.attempt(t, h, y)
        elif stage_fn is not None:
            K1 = stage_fn(t, h, y, [])
            K2 = stage_fn(t + h3, h, y, [(1.0 / 3.0, K1)])
            K3 = stage_fn(t + h3, h, y, [(1.0 / 6.0, K1), (1.0 / 6.0, K2)])
            K4 = stage_fn(t + h2, h, y, [(1.0 / 8.0, K1), (3.0 / 8.0, K3)])
            if stage5_fn is not None:
                y_spec, eps_blocks = stage5_fn(
                    t + h, h, y, [(0.5, K1), (-1.5, K3), (2.0, K4)])
            else:
                K5 = stage_fn(t + h, h, y, [(0.5, K1), (-1.5, K3), (2.0, K4)])
        else:
            K1 = rhs(t, y)
            K2 = rhs(t + h3, _axpy(h3, K1, y))
            K3 = rhs(t + h3, _axpy(h6, K1 + K2, y))
            K4 = rhs(t + h2, _axpy(h8, K1 + 3.0 * K3, y))
            K5 = rhs(t + h, _axpy(h, 0.5 * K1 - 1.5 * K3 + 2.0 * K4, y))

        steps_total += 1
        if carry_spec is not None or y_spec is not None:
            eps_t = torch.amax(eps_blocks)
        else:
            eps_t = eps_of(K1, K3, K4, K5)
        eps = float(eps_t)            # the one device sync of the attempt
        if local_mode:
            eps = eps * abs(h3)

        # eps == 0 and a NaN eps both take the factor 2 (a where() on
        # eps > 0 in the JAX package); eps == inf gives 0
        fac = 0.8 * (delta / eps) ** 0.2 if eps > 0.0 else 2.0

        nan_occurred = params.handle_nan and not math.isfinite(eps)
        accept = (eps < delta) or (abs(h) < h_min)

        if params.accept_growth_min > 1.0 and eps < delta:
            # noise-floor escape (see MersonParams.accept_growth_min):
            # genuinely accepted steps grow h by at least this factor;
            # rejected and h_min-forced steps keep the reference shrink
            fac = max(fac, params.accept_growth_min)
        new_h = fac * h

        # --- accepted-step update (only where accept & ~nan) ---
        do_update = accept and not nan_occurred
        if carry_spec is not None:
            y = attempt_fn.commit(carry_spec, do_update)
        elif do_update:
            if y_spec is not None and commit_fn is not None:
                y = commit_fn(y, y_spec, True)
            elif y_spec is not None:
                y = y_spec
            else:
                y = _axpy(h3, 0.5 * (K1 + K5) + 2.0 * K4, y)
        t_new = t + h if do_update else t
        steps_new = steps + 1 if do_update else steps

        svc_break = False
        if service_callback is not None and do_update:
            svc_break = service_callback(t_new, h, steps_new) != 0

        # --- NaN backoff (RK_MPI_SAsolver.c:541-551) ---
        left = tf - t
        h_too_small = (abs(h / left) < 1e-11) if left != 0 else False
        nan_abort = nan_occurred and h_too_small

        # --- last-step management (NEXTFINISH, RK_MPI_SAsolver.c:606-648) ---
        next_finish = abs(tf - t_new) <= abs(new_h)

        done_new = (do_update and (finished or svc_break)) or nan_abort
        if nan_abort:
            status = NAN_ABORT
        elif do_update and svc_break and not finished:
            status = INTERRUPTED

        # next h: NaN -> h/10 ; accepted+next_finish -> trimmed; else new_h
        if nan_occurred:
            h_next = h / 10.0
        elif do_update and next_finish:
            h_next = tf - t_new
        else:
            h_next = new_h
        if do_update and next_finish and not done_new:
            h_cont = new_h
        # interrupted: continue later from new_h (system->h=new_h on BREAK)
        if do_update and svc_break and not finished:
            h_cont = new_h
        finished = False if nan_occurred else (next_finish if do_update
                                               else False)

        if n_trace and do_update:
            idx = min(max(steps_new - state.steps - 1, 0), n_trace - 1)
            t_tr[idx] = t_new
            h_tr[idx] = h

        t, h, steps, done = t_new, h_next, steps_new, done_new

    if attempt_fn is not None:
        y = attempt_fn.unpack(y)

    if not done:
        status = MAX_STEPS
    # normal exits continue from the untrimmed estimate; a max_steps exit
    # must resume from the current working step
    h_out = h_cont if done else h
    new_state = MersonState(t=t, h=h_out, y=y, steps=steps,
                            steps_total=steps_total)
    if n_trace:
        trace = (torch.tensor(t_tr, dtype=torch.float64),
                 torch.tensor(h_tr, dtype=torch.float64))
        return new_state, status, trace
    return new_state, status
