"""The device-resident Merson controller: the control block, the control
and commit kernels' wrappers with their plain versions, and the loop that
replays CUDA graphs of attempts.

The counterpart of the JAX package's ``lax.while_loop`` controller
(``porousfreezethaw_tpu/solvers/merson.py:135-385``), for the freezing
attempt objects of ``stencil.py`` (float32) and those of a plain
right-hand side (:class:`RHSAttempt`: the freezing ``PlainAttempt`` and
the DEM's ``DEMAttempt``, float64 or float32).  An attempt on the device
protocol is its five stages (the ``_dev`` entries of the stage kernels,
which read their float32 scalars from the control block; or plain
PyTorch stages, which read the float64 coefficients ``hs`` and stage
times ``ts64`` through 0-d views of it), ``merson_control`` (the step
control of ``merson_solve``'s loop body, ``csrc/control.cu``, on eps
partials of either width) and ``commit`` (the accepted-state update,
read from the accept flag on the device).  :class:`DeviceLoop` captures a block of
``BLOCK`` attempts once in a CUDA graph and replays it, reading the
control block back once per replay, until the loop halts;
``solvers/merson.py merson_solve_device`` drives it.

The control block (:class:`Control`, ``csrc/control.cuh`` field by field)
lives in device memory for the kernels.  For a block on the CPU the
wrappers compute with their plain versions (``control_plain``,
``commit_plain``): the same float64 arithmetic in Python floats on the
block in place, and the commit in PyTorch.  An attempt object built with
``plain=True`` keeps its block on the CPU whatever the device of its
state, so the plain versions also run on the card.  On a block in device
memory every wrapper launches its kernel or raises; nothing falls back.

Launch counts: ``merson_control.launches`` and ``commit.launches`` (their
float64 variants apart, in ``launches_f64``), and the stage kernels' own
counters for their ``_dev`` launches.  A graph replay launches without
running the wrappers, so :class:`DeviceLoop` counts per replay what the
replay launches: each counter grows by its launches per attempt (taken
while capturing, which launches nothing, and then taken back) times
``BLOCK``.  The idle attempts after the loop halts
(a block that ends past ``done``) are launches too and are counted; so
is the idle attempt that precedes the capture.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...core import tracing
from ...models.freezing.delta import two_sum
from ...solvers.merson import NAN_ABORT, _leaves, merson_stages, pow_02

# the attempts of one captured graph: a block that ends past the loop's
# end costs its remaining attempts as empty launches (7 each on the
# freezing paths) or, on the DEM's plain stages, as whole attempts, and
# the host reads the control block once per block (chip_smoke.py phases
# controller and dem measure both; the DEM's idle attempts are 2.4% of
# the settle's wall)
BLOCK = 32

COMMIT_COPY, COMMIT_TWOSUM, COMMIT_FLIP = 0, 1, 2


class KernelLaunchError(RuntimeError):
    pass


class Control(ctypes.Structure):
    """``struct Control`` of ``csrc/control.cuh``, in the same order."""

    _fields_ = [
        ("t", ctypes.c_double), ("h", ctypes.c_double),
        ("h_cont", ctypes.c_double),
        ("tf", ctypes.c_double), ("delta", ctypes.c_double),
        ("h_min", ctypes.c_double), ("growth_min", ctypes.c_double),
        ("top1", ctypes.c_double), ("top2", ctypes.c_double),
        ("t_switch", ctypes.c_double), ("hs", ctypes.c_double * 4),
        ("ts64", ctypes.c_double * 4),
        ("steps", ctypes.c_longlong), ("steps_total", ctypes.c_longlong),
        ("start_steps", ctypes.c_longlong),
        ("start_total", ctypes.c_longlong),
        ("max_steps", ctypes.c_longlong),
        ("eps", ctypes.c_void_p), ("t_tr", ctypes.c_void_p),
        ("h_tr", ctypes.c_void_p),
        ("eps_n", ctypes.c_longlong),
        ("n_trace", ctypes.c_int),
        ("finished", ctypes.c_int), ("done", ctypes.c_int),
        ("halt", ctypes.c_int), ("status", ctypes.c_int),
        ("accept", ctypes.c_int),
        ("handle_nan", ctypes.c_int), ("local_mode", ctypes.c_int),
        ("eps_f64", ctypes.c_int),
        ("ts", ctypes.c_float * 5), ("h32", ctypes.c_float),
        ("D1", ctypes.c_float), ("dD", ctypes.c_float * 5),
    ]

    def copy(self) -> "Control":
        return Control.from_buffer_copy(self)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, with the control block's layout checked."""
    from .build import load_library
    lib = load_library()
    if lib.pft_control_size() != ctypes.sizeof(Control):
        raise KernelLaunchError(
            f"kernel library's control block has {lib.pft_control_size()} "
            f"bytes, control.py's {ctypes.sizeof(Control)}")
    return lib


def _check_rc(fn_name: str, rc: int) -> None:
    if rc != 0:
        msg = (_library().pft_error_string(rc).decode() if rc < 1000
               else "invalid arguments")
        raise KernelLaunchError(f"{fn_name} failed: {rc} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class ControlBlock:
    """One control block: ``buf``, ``sizeof(Control)`` bytes on ``device``
    (the kernels') or on the CPU (the plain versions', which work on it in
    place through ``host``), with the eps partials (float32 or float64)
    and the trace it points at.  ``hs`` are 0-d float64 views of the
    block's ``hs`` (h/3, h/6, h/8, h of the next attempt) and ``ts64`` of
    its ``ts64`` (the stage times t, t + h/3, t + h/2, t + h), which a
    stage in PyTorch reads as tensors, so that a captured graph reads each
    attempt's values and no host float is baked in."""

    def __init__(self, device: torch.device, eps: torch.Tensor):
        if eps.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"eps partials are float32 or float64, got "
                             f"{eps.dtype}")
        self.device = device
        self.eps = eps
        self.buf = torch.zeros(ctypes.sizeof(Control), dtype=torch.uint8,
                               device=device)
        self.t_tr = self.h_tr = None
        self.host: Optional[Control] = (
            Control.from_address(self.buf.data_ptr())
            if device.type == "cpu" else None)
        self.hs, self.ts64 = (self._f64_views(f)
                              for f in (Control.hs, Control.ts64))

    def _f64_views(self, field) -> tuple:
        arr = self.buf[field.offset:][:field.size].view(torch.float64)
        return tuple(arr[i] for i in range(len(arr)))

    @property
    def on_device(self) -> bool:
        return self.host is None

    def write(self, c: Control) -> None:
        if self.on_device:
            src = torch.frombuffer(bytearray(bytes(c)), dtype=torch.uint8)
            self.buf.copy_(src)
        else:
            ctypes.memmove(self.buf.data_ptr(), ctypes.addressof(c),
                           ctypes.sizeof(Control))

    def read(self) -> Control:
        """A copy of the block (a device sync on the card)."""
        if self.on_device:
            return Control.from_buffer_copy(
                self.buf.cpu().numpy().tobytes())
        return self.host.copy()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    return float(np.float32(x))


def next_scalars_plain(c: Control) -> None:
    """The scalars of the next attempt from ``c.t`` and ``c.h``, as the host
    loop's attempts form them (``csrc/control.cu`` ``next_scalars``): the
    float64 coefficients h/3, h/6, h/8, h, the float64 stage times and the
    stage kernels' float32 scalars."""
    t, h = c.t, c.h
    c.hs[:] = [h / 3, h / 6, h / 8, h]
    t3, t2, t1 = t + h / 3, t + h / 2, t + h
    c.ts64[:] = [t, t3, t2, t1]

    def top(ts):
        return c.top1 if ts < c.t_switch else c.top2

    c.ts[:] = [_f32(t), _f32(t3), _f32(t3), _f32(t2), _f32(t1)]
    c.h32 = _f32(h)
    D = top(t)
    c.D1 = _f32(D)
    c.dD[:] = [0.0, _f32(top(t3) - D), _f32(top(t3) - D), _f32(top(t2) - D),
               _f32(top(t1) - D)]


def control_plain(c: Control, eps_blocks: torch.Tensor, t_tr=None,
                  h_tr=None) -> None:
    """Plain version of the ``merson_control`` kernel: one attempt's step
    control on the block ``c`` in place, its eps the NaN-propagating max
    of ``eps_blocks``, float32 or float64 (``merson_solve``'s loop body
    after the stages, line for line, in Python floats)."""
    if c.halt:
        c.accept = 0
        return
    t, h = c.t, c.h
    h3 = h / 3
    c.steps_total += 1
    eps = float(torch.amax(eps_blocks))
    if c.local_mode:
        eps = eps * abs(h3)
    fac = 0.8 * pow_02(c.delta / eps) if eps > 0.0 else 2.0
    nan_occurred = bool(c.handle_nan) and not math.isfinite(eps)
    accept = (eps < c.delta) or (abs(h) < c.h_min)
    if c.growth_min > 1.0 and eps < c.delta:
        fac = max(fac, c.growth_min)
    new_h = fac * h
    upd = accept and not nan_occurred
    t_new = t + h if upd else t
    steps_new = c.steps + 1 if upd else c.steps
    left = c.tf - t
    too_small = (abs(h / left) < 1e-11) if left != 0 else False
    nan_abort = nan_occurred and too_small
    next_finish = abs(c.tf - t_new) <= abs(new_h)
    done = (upd and bool(c.finished)) or nan_abort
    if nan_abort:
        c.status = NAN_ABORT
    if nan_occurred:
        h_next = h / 10.0
    elif upd and next_finish:
        h_next = c.tf - t_new
    else:
        h_next = new_h
    if upd and next_finish and not done:
        c.h_cont = new_h
    c.finished = 0 if nan_occurred else int(next_finish if upd else False)
    if c.n_trace > 0 and upd:
        idx = min(max(steps_new - c.start_steps - 1, 0), c.n_trace - 1)
        t_tr[idx] = t_new
        h_tr[idx] = h
    c.t, c.h, c.steps = t_new, h_next, steps_new
    c.done, c.accept = int(done), int(upd)
    c.halt = int(done or c.steps_total - c.start_total >= c.max_steps)
    next_scalars_plain(c)


def commit_plain(c: Control, mode: int, hi: torch.Tensor, lo=None, src=None,
                 cur=None) -> None:
    """Plain version of the ``commit`` kernel on any device."""
    if not c.accept:
        return
    if mode == COMMIT_COPY:
        hi.copy_(src)
    elif mode == COMMIT_TWOSUM:
        s, err = two_sum(hi, lo, src)
        hi.copy_(s)
        lo.copy_(err)
    else:
        cur.bitwise_xor_(1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def merson_control(ctl: ControlBlock) -> None:
    """One attempt's step control on ``ctl``: the kernel for a block in
    device memory, else its plain version.  The block's ``eps_f64`` must
    say the width of ``ctl.eps`` (``DeviceLoop.begin`` writes it)."""
    if not ctl.on_device:
        return control_plain(ctl.host, ctl.eps, ctl.t_tr, ctl.h_tr)
    with torch.cuda.device(ctl.device):
        rc = _library().pft_merson_control(ctl.buf.data_ptr(),
                                           _stream(ctl.device))
    _check_rc("pft_merson_control", rc)
    if ctl.eps.dtype == torch.float64:
        merson_control.launches_f64 += 1
    else:
        merson_control.launches += 1


merson_control.launches = merson_control.launches_f64 = 0


def commit(ctl: ControlBlock, mode: int, hi: torch.Tensor, lo=None,
           src=None, cur=None) -> None:
    """The accepted-state update of one attempt, when ``ctl``'s accept
    flag is set: ``COMMIT_COPY`` copies ``src`` into ``hi``,
    ``COMMIT_TWOSUM`` adds ``src`` into ``(hi, lo)`` by TwoSum,
    ``COMMIT_FLIP`` flips the int32 slot index ``cur``.  The kernel for a
    block in device memory (contiguous planes of one shape on its device:
    float32, or float32 or float64 for the copy), else the plain
    version."""
    if not ctl.on_device:
        return commit_plain(ctl.host, mode, hi, lo, src, cur)
    if mode not in (COMMIT_COPY, COMMIT_TWOSUM, COMMIT_FLIP):
        raise ValueError(f"commit: unknown mode {mode}")
    planes = [x for x in (hi, lo, src) if x is not None]
    dtypes = ((torch.float32, torch.float64) if mode == COMMIT_COPY
              else (torch.float32,))
    for x in planes:
        if (x.device != ctl.device or x.dtype not in dtypes
                or x.dtype != planes[0].dtype
                or not x.is_contiguous() or x.shape != planes[0].shape):
            raise ValueError(
                f"commit: contiguous {' or '.join(map(str, dtypes))} "
                f"planes of one shape and type on {ctl.device}")
    if mode == COMMIT_FLIP and (cur is None or cur.device != ctl.device
                                or cur.dtype != torch.int32):
        raise ValueError(f"commit: cur must be int32 on {ctl.device}")

    def ptr(x):
        return None if x is None else x.data_ptr()

    n = 0 if mode == COMMIT_FLIP else hi.numel()
    wide = mode == COMMIT_COPY and hi.dtype == torch.float64
    with torch.cuda.device(ctl.device):
        rc = _library().pft_commit(ctl.buf.data_ptr(), mode, ptr(hi),
                                   ptr(lo), ptr(src), ptr(cur), n,
                                   8 if wide else 4, _stream(ctl.device))
    _check_rc("pft_commit", rc)
    if wide:
        commit.launches_f64 += 1
    else:
        commit.launches += 1


commit.launches = commit.launches_f64 = 0


def pow_02_device(q: torch.Tensor) -> torch.Tensor:
    """The control kernel's ``pow_02`` on the float64 values ``q`` on the
    card (to compare it with the host's ``solvers.merson.pow_02``)."""
    if q.device.type != "cuda" or q.dtype != torch.float64:
        raise ValueError("pow_02_device: float64 values on a CUDA device")
    q = q.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _library().pft_pow_02(q.data_ptr(), out.data_ptr(), q.numel(),
                                   _stream(q.device))
    _check_rc("pft_pow_02", rc)
    return out


def _counters():
    """The launch counters an attempt's launches add to."""
    from . import stencil as st
    return [(st.fused_stage, "launches"), (st.fused_attempt, "launches"),
            (st.delta_g, "launches"), (st.delta_g, "launches_dy"),
            (st.fused_stage_shard, "launches"),
            (st.fused_stage_shard, "launches_split"),
            (st.delta_g_shard, "launches"), (st.delta_g_shard, "launches_dy"),
            (merson_control, "launches"), (commit, "launches"),
            (merson_control, "launches_f64"), (commit, "launches_f64")]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

class DeviceAttempt:
    """The device protocol of an attempt object (``merson_solve_device``).

    Subclasses allocate the buffers of a device once (``_dev_alloc``: a
    dict of the state, the stage outputs and, under ``"eps"``, the eps
    partials, float32 or float64, with as many slots as the kernels' tail
    has blocks when ``kernel``, else one, or one a leaf for the DEM), copy
    a state in (``_dev_load``) and out (``_dev_unpack``, a copy), and
    enqueue one attempt on a control block (``_dev_attempt``): its stage
    launches, ``merson_control`` and ``commit``, every launch on the same
    buffers (or on memory that a capture's pool holds), so that a block of
    attempts can be captured once.  ``dirichlet`` is (top1, top2,
    t_switch) of the Dirichlet top, from which the control block forms the
    delta kernel's D1 and dDi."""

    plain = False
    dirichlet: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def _dev_alloc(self, device: torch.device, kernel: bool) -> dict:
        raise NotImplementedError

    def _dev_load(self, bufs: dict, y) -> None:
        raise NotImplementedError

    def _dev_attempt(self, ctl: ControlBlock, bufs: dict) -> None:
        raise NotImplementedError

    def _dev_unpack(self, bufs: dict):
        raise NotImplementedError

    def device_loop(self, device: torch.device) -> "DeviceLoop":
        """The loop of this object on ``device``, made at first use."""
        loops = self.__dict__.setdefault("_dev_loops", {})
        if device not in loops:
            loops[device] = DeviceLoop(self, device)
        return loops[device]


class RHSAttempt(DeviceAttempt):
    """A Merson attempt of a plain PyTorch right-hand side ``rhs`` on the
    device protocol: ``merson_solve``'s plain-RHS attempt operation for
    operation (``merson_stages`` on the block's 0-d float64 views ``hs``
    and, where ``timed``, ``ts64``; then per leaf the NaN-propagating max
    of ``leaf_eps``'s error and the update ``y + (0.5 (K1 + K5) + 2 K4)
    h/3``), ``merson_control`` and the copy commit of the update into the
    state.  A 0-d float64 tensor in ``x * a`` rounds ``a`` to the field
    dtype as a Python float does, so the two loops agree bit for bit.
    The subclasses are the DEM's ``DEMAttempt`` (untimed: its right-hand
    side reads no time) and the freezing ``PlainAttempt``.

    ``_dev_alloc`` gives ``y`` and ``spec`` (one static tensor each),
    ``leaves``, the state as ``rhs`` takes it (views of ``y``: a tensor or
    a dict of tensors), and ``spec_leaves`` and ``eps_leaves`` of the
    same structure (views of ``spec`` and 0-d views of ``eps``, one slot
    a leaf in the field dtype).  These stages are PyTorch operations,
    which cannot return early: each idle attempt of a block that ends
    past the loop's end runs its five right-hand sides (the control
    kernel sets accept to 0 and the commit copies nothing)."""

    timed = True

    def _dev_attempt(self, ctl: ControlBlock, b: dict) -> None:
        y = b["leaves"]
        ts = ctl.ts64 if self.timed else (None,) * 4
        K1, K3, K4, K5 = merson_stages(self.rhs, y, ctl.hs, ts)
        h3 = ctl.hs[0]

        def leaf(yv, k1, k3, k4, k5, spec, eps):
            torch.amax(torch.abs(0.2 * k1 - 0.9 * k3 + 0.8 * k4 - 0.1 * k5),
                       out=eps)
            torch.add(yv, (0.5 * (k1 + k5) + 2.0 * k4) * h3, out=spec)

        _leaves(leaf, y, K1, K3, K4, K5, b["spec_leaves"], b["eps_leaves"])
        merson_control(ctl)
        commit(ctl, COMMIT_COPY, b["y"], src=b["spec"])


def _block_times(blk, start, end, prev_end) -> None:
    """A block span's device times (us) from its events, once its
    read-back has synchronized them."""
    blk.attrs["device_us"] = 1e3 * start.elapsed_time(end)
    if prev_end is not None:
        blk.attrs["gap_us"] = 1e3 * prev_end.elapsed_time(start)


class DeviceLoop:
    """The device-resident loop of one attempt object on one device: its
    static buffers, its control block and its graph of ``BLOCK``
    attempts, captured at first use and kept.  ``capture_s`` is the wall
    time of the capture (the idle attempt before it, the capture and the
    graph's instantiation: the ``pft.loop.capture`` span), None before
    it.

    While ``tracing.hot()``, each block is a ``pft.loop.block`` span with
    its ``pft.loop.replay`` (the attempts) and ``pft.loop.readback`` (the
    control block's copy) and, on the card, the attributes ``device_us``
    (device time from a CUDA event recorded just before the graph's
    launch to one just after it: the launch's latency and the attempts)
    and, after a run's first block, ``gap_us`` (device time from the
    previous block's end event to this block's start event: the
    read-back's copy and the host's work up to the next launch)."""

    def __init__(self, attempt: DeviceAttempt, device: torch.device):
        self.attempt = attempt
        self.kernel = device.type == "cuda" and not attempt.plain
        self.bufs = attempt._dev_alloc(device, self.kernel)
        self.ctl = ControlBlock(device if self.kernel
                                else torch.device("cpu"), self.bufs["eps"])
        self.capture_s: Optional[float] = None
        self._captured: Optional[Tuple[torch.cuda.CUDAGraph, list]] = None
        # the block events of the hot instrumentation: three (start, end)
        # pairs, made at first use and reused, so that no block allocates
        self._events = None

    def begin(self, y, *, t: float, h: float, h_cont: float, steps: int,
              steps_total: int, finished: bool, tf: float, params) -> None:
        """Load the state ``y`` and write the control block of a solve
        call from the prologue's values and ``params`` (MersonParams); on
        the card, capture the graph at first use."""
        self.attempt._dev_load(self.bufs, y)
        ctl = self.ctl
        n = int(params.record_trace)
        ctl.t_tr = ctl.h_tr = None
        if n:
            ctl.t_tr, ctl.h_tr = (torch.zeros(n, dtype=torch.float64,
                                              device=ctl.device)
                                  for _ in range(2))
        top1, top2, t_switch = self.attempt.dirichlet
        c = Control(
            t=t, h=h, h_cont=h_cont, tf=tf, delta=float(params.delta),
            h_min=float(params.h_min),
            growth_min=float(params.accept_growth_min),
            top1=top1, top2=top2, t_switch=t_switch,
            steps=steps, steps_total=steps_total, start_steps=steps,
            start_total=steps_total,
            max_steps=min(int(params.max_steps), 2**62),
            eps=ctl.eps.data_ptr(), eps_n=ctl.eps.numel(),
            eps_f64=int(ctl.eps.dtype == torch.float64),
            t_tr=ctl.t_tr.data_ptr() if n else None,
            h_tr=ctl.h_tr.data_ptr() if n else None, n_trace=n,
            finished=int(finished), done=0,
            halt=int(not params.max_steps > 0), status=0, accept=0,
            handle_nan=int(params.handle_nan),
            local_mode=int(params.delta_mode == "local"))
        next_scalars_plain(c)
        ctl.write(c)
        if self.kernel:
            self._graph()

    def run(self) -> Control:
        """Attempts until the loop halts; returns the final block.  On the
        card: replays of the graph of ``BLOCK`` attempts, one read-back
        each; else one plain attempt after another."""
        graph, per_attempt = (self._graph() if self.kernel
                              else (None, None))
        if tracing.hot():
            return self._run_traced(graph, per_attempt)
        if not self.kernel:
            while not self.ctl.host.halt:
                self.attempt._dev_attempt(self.ctl, self.bufs)
            return self.ctl.read()
        while True:
            graph.replay()
            self._count(per_attempt)
            c = self.ctl.read()
            if c.halt:
                return c

    @staticmethod
    def blocks(c: Control) -> int:
        """The blocks of the run that returned ``c``: its attempts in
        blocks of ``BLOCK``, the last one partly idle, and one block where
        the call had no attempt to make (on the card, replays)."""
        return max(1, -(-(c.steps_total - c.start_total) // BLOCK))

    @staticmethod
    def _count(per_attempt) -> None:
        """The launches of one replay, added to their counters."""
        for (obj, attr), n in per_attempt:
            setattr(obj, attr, getattr(obj, attr) + n * BLOCK)

    def _run_traced(self, graph, per_attempt) -> Control:
        """``run``'s loop with the hot instrumentation: each block in its
        spans and, on the card, between the CUDA events of pair ``k % 3``
        (the plain loop's block: up to ``BLOCK`` attempts, until the
        block halts).  A block's device times are read while the next
        block runs, off the boundary's path; the third pair keeps the
        events they read from being recorded again before that."""
        if self.kernel:
            if self._events is None:
                self._events = [tuple(torch.cuda.Event(enable_timing=True)
                                      for _ in range(2)) for _ in range(3)]
            stream = torch.cuda.current_stream(self.ctl.device)
        done = None           # (block span, start, end, previous end)
        for k in itertools.count():
            with tracing.span("pft.loop.block") as blk:
                with tracing.span("pft.loop.replay"):
                    if self.kernel:
                        start, end = self._events[k % 3]
                        start.record(stream)
                        graph.replay()
                        end.record(stream)
                    else:
                        for _ in range(BLOCK):
                            if self.ctl.host.halt:
                                break
                            self.attempt._dev_attempt(self.ctl, self.bufs)
                if self.kernel:
                    if done is not None:
                        _block_times(*done)
                    self._count(per_attempt)
                with tracing.span("pft.loop.readback"):
                    c = self.ctl.read()
                if self.kernel:
                    prev_end = None if done is None else done[2]
                    done = (blk, start, end, prev_end)
            if c.halt:
                if done is not None:
                    _block_times(*done)
                return c

    def resume(self, c: Control) -> None:
        """Continue a halted, unfinished solve from its block ``c`` (as
        ``run`` returned it) for another ``max_steps`` attempts: the same
        loop state, a new count and trace."""
        c = c.copy()
        c.start_steps, c.start_total, c.halt = c.steps, c.steps_total, 0
        self.ctl.write(c)

    def trace(self):
        return (self.ctl.t_tr.cpu(), self.ctl.h_tr.cpu())

    def unpack(self):
        return self.attempt._dev_unpack(self.bufs)

    def _graph(self):
        """The graph of ``BLOCK`` attempts and the launches per attempt of
        each counter, captured at first use.  One idle attempt on a halted
        block first makes each kernel's first-use set-up (its attributes
        and occupancy query; a plain stage's constants), which a capture
        must not meet; the block is restored after, and the counters keep
        that attempt's launches but not the capture's, which launches
        nothing."""
        if self._captured is not None:
            return self._captured
        with tracing.span("pft.loop.capture") as sp:
            self._captured = self._capture()
        self.capture_s = sp.seconds
        return self._captured

    def _capture(self):
        ctl = self.ctl
        saved = ctl.read()
        idle = saved.copy()
        idle.halt = 1
        ctl.write(idle)
        counters = _counters()
        before = [getattr(o, a) for o, a in counters]
        self.attempt._dev_attempt(ctl, self.bufs)
        torch.cuda.synchronize(ctl.device)
        mid = [getattr(o, a) for o, a in counters]
        graph = torch.cuda.CUDAGraph()
        # the graphs of attempt objects dropped earlier (an attempt and
        # its loop hold each other) are freed here: a collection during
        # the capture would destroy a graph there, which invalidates it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(ctl.device), torch.cuda.graph(graph):
                for _ in range(BLOCK):
                    self.attempt._dev_attempt(ctl, self.bufs)
        finally:
            if collecting:
                gc.enable()
        per_attempt = []
        for (o, a), b0, b1 in zip(counters, before, mid):
            n, rem = divmod(getattr(o, a) - b1, BLOCK)
            if rem or n != b1 - b0:
                raise KernelLaunchError(
                    f"capture: {o.__name__}.{a} took {getattr(o, a) - b1} "
                    f"launches for {BLOCK} attempts")
            per_attempt.append(((o, a), n))
            setattr(o, a, b1)
        ctl.write(saved)
        torch.cuda.synchronize(ctl.device)
        return graph, per_attempt
