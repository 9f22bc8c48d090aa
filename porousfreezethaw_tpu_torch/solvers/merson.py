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

The state ``y`` is one tensor, a dict of tensors (the DEM's {pos, vel,
angvel}), or a list of either (a sharded state: one entry a shard, each
on its device), on which every step runs per leaf and eps is the max of
the leaves' maxima (NaN-propagating, as ``jnp.maximum`` over the JAX
package's pytree leaves), gathered on the first leaf's device.  The
controller scalars t, h and eps are Python floats (f64) whatever the
field dtype: f32 time accumulation breaks down over the reference's
36000 s runs (ulp(36000) in f32 is ~4 ms vs steps ~20 ms).

Two loops.  ``merson_solve``, the host loop, runs the accept/reject
loop in Python and reads eps back with one device sync per attempt; the
service callback is a plain Python call after each accepted step.
``merson_solve_device``, the counterpart of the JAX package's
``lax.while_loop``, runs it on the device for the attempt objects of
ops/cuda/stencil.py and those of a plain right-hand side
(models/freezing/attempt.py, models/dem/attempt.py): the step
control and the commit are kernels (ops/cuda/control.py), a block of
attempts is one CUDA graph, and the host reads the control block back
once per block; it gives the host loop's bits.  Both take the growth factor's power from ``pow_02``, the
correctly rounded ``q ** 0.2``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core import tracing

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
    y: Any                 # solution tensor, or dict of tensors
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


def pow_02(q: float) -> float:
    """``q ** 0.2`` correctly rounded, for ``q >= 0``: the step-growth
    power of the controller.

    Python's ``**`` calls the C library's ``pow``, which misrounds about
    one result in a thousand here (glibc 2.36: 371 of 425,406 random q in
    [1e-3, 1e4]), and the device's ``pow`` is not correctly rounded
    either; the correctly rounded value is the one both controllers can
    give (csrc/control.cuh ``pow_02`` is this function in double-double).
    ``y = q ** 0.2`` is within an ulp of it; each step compares the exact
    value with the midpoint ``m`` between y and a neighbour.  As 0.2 is
    1/5 + 2**-54/5 in binary, ``(q ** 0.2)**5 = q exp(ln(q) 2**-54)``,
    which ``T = q (1 + L 2**-54)``, ``L = log(q)`` rounded, gives to about
    2**-100 relative; T and ``m**5`` are compared exactly in integers."""
    y = q ** 0.2
    if not 0.0 < y < math.inf:
        return y
    qn, qd = q.as_integer_ratio()
    ln_, ld = math.log(q).as_integer_ratio()
    tn, td = qn * ((ld << 54) + ln_), (qd * ld) << 54

    def above(z):
        """Whether q ** 0.2 lies above the midpoint of y and z (z - y to
        the side of z)."""
        yn, yd = y.as_integer_ratio()
        zn, zd = z.as_integer_ratio()
        mn, md = yn * zd + zn * yd, 2 * yd * zd
        return (tn * md ** 5 > mn ** 5 * td) == (z > y)

    for _ in range(8):
        for z in (math.nextafter(y, math.inf), math.nextafter(y, 0.0)):
            if above(z):
                y = z
                break
        else:
            break
    return y


def merson_init(y0, t0: float = 0.0, h0: float = 1.0) -> MersonState:
    return MersonState(t=float(t0), h=float(h0), y=y0, steps=0,
                       steps_total=0)


def _axpy(a: float, x, y):
    """y + a*x per leaf.  ``a`` goes to the kernel as a scalar argument,
    which PyTorch rounds to the field dtype first, so f64 controller
    scalars never upcast f32 fields."""
    return _leaves(lambda yv, xv: yv + xv * a, y, x)


def merson_stages(rhs, y, hs, ts):
    """The five stages of a plain-RHS Merson attempt from ``y``:
    (K1, K3, K4, K5).  ``hs`` are the coefficients (h/3, h/6, h/8, h) and
    ``ts`` the stage times (t, t + h/3, t + h/2, t + h): Python floats in
    the host loop, 0-d float64 views of the control block in the device
    loop's attempts (ops/cuda/control.py ``RHSAttempt``), which thus run
    the host loop's operations one for one."""
    h3, h6, h8, h = hs
    t, t3, t2, t1 = ts
    K1 = rhs(t, y)
    K2 = rhs(t3, _axpy(h3, K1, y))
    K3 = rhs(t3, _axpy(h6, _leaves(torch.add, K1, K2), y))
    K4 = rhs(t2, _axpy(h8, _leaves(lambda a, b: a + 3.0 * b, K1, K3), y))
    K5 = rhs(t1, _axpy(h, _leaves(
        lambda a, b, c: 0.5 * a - 1.5 * b + 2.0 * c, K1, K3, K4), y))
    return K1, K3, K4, K5


def _leaves(fn, *trees):
    """``fn`` over the matching leaves of trees of dicts and lists of
    tensors (a tensor is a tree of one leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _leaves(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, list):
        return [_leaves(fn, *(u[i] for u in trees)) for i in range(len(t))]
    return fn(*trees)


def _flat(tree):
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [x for sub in tree for x in _flat(sub)]
    return [tree]


def _max_of_leaves(per_leaf):
    """The max of per-leaf maxima, NaN-propagating as ``jnp.maximum``, on
    the first leaf's device; a tensor's own max as it is."""
    leaves = _flat(per_leaf)
    dev = leaves[0].device
    return functools.reduce(torch.maximum, (x.to(dev) for x in leaves))


def _prologue(state: MersonState, tf: float):
    """(t0, h, h_cont, prefinished) of a solve call to ``tf``: h reversed
    toward tf, the first step pre-truncated (RK_MPI_SAsolver.c:300-307);
    the continuation h stays at the (reversed) input value unless a
    NEXTFINISH saves a fresh untrimmed estimate."""
    t0, h0 = float(state.t), float(state.h)
    h_rev = -h0 if ((tf > t0 and h0 < 0) or (tf < t0 and h0 > 0)) else h0
    prefinished = (h_rev == 0) or (abs(tf - t0) <= abs(h_rev))
    return t0, (tf - t0 if prefinished else h_rev), h_rev, prefinished


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

    ``rhs(t, y) -> dy/dt``, on a tensor, a dict of tensors or a list of
    either.  ``eps_mult`` is an optional tensor of per-cell error
    multipliers broadcast against a tensor ``y`` (chunk_eps_mult), or the
    list of its shards for a list of tensors (sharded with the state).

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

    t0, h, h_cont, prefinished = _prologue(state, tf)

    if attempt_fn is not None and eps_mult is not None:
        raise ValueError("eps_mult is not supported with attempt_fn")
    stage5_fn = getattr(stage_fn, "stage5", None) if eps_mult is None else None
    commit_fn = getattr(stage_fn, "commit", None)
    if getattr(stage_fn, "k_partial", False) and stage5_fn is None:
        raise ValueError(
            "this stage_fn emits partial-state K arrays and requires its "
            ".stage5 tail (eps_mult is unsupported with it)")

    if eps_mult is not None and not (
            isinstance(state.y, torch.Tensor) and torch.is_tensor(eps_mult)
            or isinstance(state.y, list) and isinstance(eps_mult, list)
            and all(torch.is_tensor(s) for s in state.y + eps_mult)):
        raise ValueError("eps_mult is a tensor for a tensor state, or a "
                         "list of shards for a list of tensors")

    def leaf_eps(k1, k3, k4, k5, mult=None):
        err = torch.abs(0.2 * k1 - 0.9 * k3 + 0.8 * k4 - 0.1 * k5)
        if mult is not None:
            err = mult * err
        return torch.amax(err)

    def eps_of(K1, K3, K4, K5):
        mult = () if eps_mult is None else (eps_mult,)
        return _max_of_leaves(_leaves(leaf_eps, K1, K3, K4, K5, *mult))

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
            K1, K3, K4, K5 = merson_stages(rhs, y, (h3, h6, h8, h),
                                           (t, t + h3, t + h2, t + h))

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
        fac = 0.8 * pow_02(delta / eps) if eps > 0.0 else 2.0

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
                y = _axpy(h3, _leaves(lambda a, b, c: 0.5 * (a + c)
                                      + 2.0 * b, K1, K4, K5), y)
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


def host_loop_reason(device: torch.device, mesh=None) -> Optional[str]:
    """Why a solve on ``device`` (sharded over ``mesh``, if given) runs
    the host loop (``merson_solve``), or None where it runs the device
    loop (``merson_solve_device``): the one rule of the freezing app, the
    spheres app (``models.dem.dem_solver``) and the bench.  The device
    loop serves the card, a mesh whose shards all share one CUDA device
    included (virtual shards of one card); the CPU keeps the host loop, as
    the JAX apps do there, and so does a mesh over several cards, whose
    capture is unverified.  It is not a fallback: a failed capture or
    launch raises."""
    if device.type != "cuda":
        return f"--device {device.type}"
    if mesh is not None:
        n = len(set(mesh.device_list()))
        if n > 1:
            return f"shards on {n} devices"
    return None


def uses_device_loop(device: torch.device, mesh=None) -> bool:
    """Whether a solve on ``device`` over ``mesh`` runs the device loop
    (``host_loop_reason`` is None)."""
    return host_loop_reason(device, mesh) is None


def merson_solve_device(state: MersonState, final_time: float,
                        params: MersonParams, attempt_fn, between=None):
    """``merson_solve(None, state, final_time, params,
    attempt_fn=attempt_fn)`` with the loop on the device: the counterpart
    of the JAX package's ``lax.while_loop`` solve.  Returns what
    merson_solve returns, ``(state, status)`` or, with ``record_trace``,
    ``(state, status, (t_trace, h_trace))``, the same bits.

    ``attempt_fn`` is an attempt object on the device protocol
    (ops/cuda/control.py ``DeviceAttempt``: ``DeltaAttempt``,
    ``DeltaAttemptComp``, ``FusedAttempt``, ``StageAttempt`` on a float32
    freezing state, and parallel/fused.py's sharded attempts on the list
    of its shards; models/freezing/attempt.py ``PlainAttempt`` on a
    float64 or float32 one, or on the shards of a mesh;
    models/dem/attempt.py ``DEMAttempt`` on the DEM's dict state, or the
    list of its shards' dicts, float64 or float32).  A sharded state's
    shards share one device.  The prologue forms h in float64 here and
    writes the control block; each attempt's step control is the
    ``merson_control`` kernel and its commit the ``commit`` kernel,
    reading the accept flag on the device.  On the card the loop replays a
    CUDA graph of control.py's ``BLOCK`` attempts, captured at first use
    per attempt object and device and kept across calls, and reads the
    control block back once per replay until the loop halts (done, or
    ``max_steps`` attempts in this call).  For a state on the CPU, or an object built with
    ``plain=True``, the same loop runs the plain versions attempt by
    attempt, with no graph.  Nothing falls back to the host loop: a failed
    capture or launch raises.  There is no per-step service callback: a
    caller records the trace (``record_trace``) and drains it between
    chunks of ``max_steps`` attempts.

    ``between(t_trace, h_trace, n, steps)``, if given, makes the call run
    to its end in such chunks: it is called after each chunk with the
    trace of its ``n`` accepted steps, ``steps`` the count before them; a
    True return ends the call there, else a chunk that did not end the
    solve is followed by the next one on the same control block.  Unlike a
    new call after a ``MAX_STEPS`` exit, that keeps the untrimmed
    continuation h when a chunk ends between the step that trims the last
    one and the last one itself, so the chunks give one call's bits.
    """
    if params.delta_mode not in ("global", "local"):
        raise ValueError(f"unknown delta_mode {params.delta_mode!r}")
    if between is not None and not params.record_trace:
        raise ValueError("between= drains the trace: set record_trace")
    tf = float(final_time)
    t0, h, h_cont, prefinished = _prologue(state, tf)
    # the loop lives on the device of the state's leaves: a sharded state's
    # shards share it (host_loop_reason)
    devices = {x.device for x in _flat(state.y)}
    if len(devices) != 1:
        raise ValueError(f"merson_solve_device: the state lies on "
                         f"{len(devices)} devices; the device loop serves "
                         f"one (host_loop_reason)")
    with tracing.span("pft.solve", root=True,
                      path=type(attempt_fn).__name__) as sp:
        with tracing.span("pft.loop.begin"):
            loop = attempt_fn.device_loop(devices.pop())
            loop.begin(state.y, t=t0, h=h, h_cont=h_cont,
                       steps=int(state.steps),
                       steps_total=int(state.steps_total),
                       finished=prefinished, tf=tf, params=params)
        prev = int(state.steps)
        blocks = 0
        stop = False
        while not stop:
            # one chunk of attempts and, with between=, its drain and the
            # next chunk's start, so that the boundary lies in one span
            with tracing.span("pft.loop.run"):
                c = loop.run()
                blocks += loop.blocks(c)
                stop = between is None
                if not stop:
                    with tracing.span("pft.loop.chunk"):
                        t_tr, h_tr = loop.trace()
                        stop = bool(between(t_tr, h_tr, int(c.steps) - prev,
                                            prev) or c.done)
                        if not stop:
                            prev = int(c.steps)
                            loop.resume(c)
        done = bool(c.done)
        with tracing.span("pft.loop.unpack"):
            # normal exits continue from the untrimmed estimate; a
            # max_steps exit must resume from the current working step
            new_state = MersonState(t=c.t, h=c.h_cont if done else c.h,
                                    y=loop.unpack(), steps=int(c.steps),
                                    steps_total=int(c.steps_total))
            trace = loop.trace() if params.record_trace else None
        sp.attrs.update(attempts=new_state.steps_total - state.steps_total,
                        accepted=new_state.steps - state.steps,
                        blocks=blocks)
    status = int(c.status) if done else MAX_STEPS
    if params.record_trace:
        return new_state, status, trace
    return new_state, status
