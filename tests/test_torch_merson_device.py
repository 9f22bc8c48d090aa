"""The device-resident Merson loop (``merson_solve_device``) through the
plain versions of its control and commit kernels on the CPU, against the
host loop (``merson_solve``) bit for bit, and against the JAX package's
``merson_solve``.

* A scalar f64 ODE whose attempt follows the device protocol
  (``ToyAttempt``: the host loop's attempt_fn protocol and the device
  protocol on one Merson attempt), over every branch of the step control:
  eps below and above delta, eps = 0, inf and NaN, |h| < h_min, the growth
  floor, the NaN backoff and its abort, the trimming of the last step and
  its continuation across calls, max_steps, the trace and its clipping,
  the local mode, a backward solve and a prefinished first step.  State,
  t, h, counts, status and trace equal the host loop's bit for bit.
* The four freezing attempt paths (``DeltaAttempt``, ``DeltaAttemptComp``,
  ``FusedAttempt`` and the classic stage path, ``plain=True``) at
  16x16x32, across the Dirichlet phase switch, in chunks of max_steps with
  a trace, bit for bit against the host loop.
* The same scalar cases in chunks against the JAX ``merson_solve`` (x64):
  equal step counts and statuses, t and h within tests/test_torch_merson.py's
  T_RTOL and H_RTOL; the delta path against the JAX ``DeltaAttempt`` in
  interpret mode: equal counts, t to 1e-2 (float32 eps in other orders,
  as in tests/test_torch_compensated.py).
* The commit's three modes with the flag at 0 and 1, the correctly rounded
  growth power, and the control block's layout against csrc/control.cuh.
"""

import ctypes
import dataclasses
import decimal
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.ops.pallas import stencil as jst
from porousfreezethaw_tpu.solvers import merson as jm
from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config import parse_param_file
from porousfreezethaw_tpu_torch.convert import params_from_reference
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    FreezingParams, shift_temperature_origin)
from porousfreezethaw_tpu_torch.ops.cuda import control as ctl_mod
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from porousfreezethaw_tpu_torch.solvers import merson as tm
from tests.test_freezing_equation import default_params
from tests.test_torch_merson import H_RTOL, T_RTOL

torch.set_num_threads(1)


class ToyAttempt(ctl_mod.DeviceAttempt):
    """One Merson attempt of dy/dt = f(t, y) in float64, on both
    protocols; its eps partials are the error's maxima over ``blocks``
    slices of y, so the control step reduces several partials.  With
    ``script``, attempt i takes eps = script[i] while the script lasts."""

    def __init__(self, f, blocks=2, script=()):
        self.f = f
        self.blocks = blocks
        self.script = list(script)

    def _attempt(self, t, h, y):
        f, h3 = self.f, h / 3
        K1 = f(t, y)
        K2 = f(t + h3, y + h3 * K1)
        K3 = f(t + h3, y + (h / 6) * (K1 + K2))
        K4 = f(t + h / 2, y + (h / 8) * (K1 + 3.0 * K3))
        K5 = f(t + h, y + h * (0.5 * K1 - 1.5 * K3 + 2.0 * K4))
        err = torch.abs(0.2 * K1 - 0.9 * K3 + 0.8 * K4 - 0.1 * K5)
        eps = torch.stack([torch.amax(e) for e in
                           torch.tensor_split(err, self.blocks)])
        if self.script:
            eps[0] = self.script.pop(0)
            eps[1:] = 0.0
        return y + h3 * (0.5 * (K1 + K5) + 2.0 * K4), eps

    # merson_solve's attempt_fn protocol
    def pack(self, y):
        return y.clone()

    def attempt(self, t, h, y):
        y_spec, eps = self._attempt(t, h, y)
        return (y, y_spec), eps

    def commit(self, carry, accept):
        y, y_spec = carry
        if accept:
            y.copy_(y_spec)
        return y

    def unpack(self, y):
        return y

    # the device protocol
    def _dev_alloc(self, device, kernel):
        return {"eps": torch.zeros(self.blocks, dtype=torch.float64)}

    def _dev_load(self, b, y):
        b["y"] = y.clone()
        b["out"] = torch.empty_like(y)

    def _dev_attempt(self, ctl, b):
        c = ctl.host
        y_spec, eps = self._attempt(c.t, c.h, b["y"])
        b["out"].copy_(y_spec)
        b["eps"].copy_(eps)
        ctl_mod.merson_control(ctl)
        ctl_mod.commit(ctl, ctl_mod.COMMIT_COPY, b["y"], src=b["out"])

    def _dev_unpack(self, b):
        return b["y"].clone()


def decay(t, y):
    return -y


def stiff(t, y):
    return torch.stack([-1000.0 * (y[0] - math.cos(t)), y[0] - y[1]])


def overflow(t, y):
    # inf above |y| = 100: a large h overflows the stage cascade
    return torch.where(torch.abs(y) > 100.0, torch.inf, -y)


def still(t, y):
    return torch.zeros_like(y)


def poisoned(t, y):
    return torch.full_like(y, math.nan)


RHS = {"decay": (decay, [1.0, 2.0, -3.0]), "stiff": (stiff, [0.0, 1.0]),
       "overflow": (overflow, [1.0, 0.5]), "still": (still, [1.0, -2.0]),
       "poisoned": (poisoned, [1.0, 2.0])}

# name -> (rhs, t0, h0, legs, MersonParams arguments[, eps script])
CASES = {
    "decay": ("decay", 0.0, 0.1, [5.0], dict(delta=1e-8)),
    "stiff": ("stiff", 0.0, 1e-3, [0.5], dict(delta=1e-5)),
    "local": ("stiff", 0.0, 1e-3, [0.5],
              dict(delta=1e-7, delta_mode="local")),
    "growth_floor": ("stiff", 0.0, 1e-3, [0.5],
                     dict(delta=1e-5, accept_growth_min=1.05)),
    # delta below the reachable error: |h| < h_min forces the accepts
    "h_min": ("decay", 0.0, 0.1, [2.0], dict(delta=1e-10, h_min=0.05)),
    # eps = 0 on every attempt: the factor 2, the last step trimmed
    "eps_zero": ("still", 0.0, 0.01, [1.0], dict(delta=1e-8)),
    # eps = inf: the backoff divides h by 10 until it is finite
    "nan_backoff": ("overflow", 0.0, 1e3, [4.0],
                    dict(delta=1e-6, handle_nan=True)),
    # eps = 0 (factor 2), NaN (factor 2, rejected), below and above
    # delta, then inf (factor 0: h = 0 for good), without the backoff
    "eps_edges": ("decay", 0.0, 0.1, [4.0], dict(delta=1e-8, max_steps=7),
                  [0.0, math.nan, 1e-12, 1e-3, math.inf]),
    # the same with the backoff: NaN and inf divide h by 10
    "eps_edges_backoff": ("decay", 0.0, 0.1, [4.0],
                          dict(delta=1e-8, max_steps=7, handle_nan=True),
                          [math.nan, 1e-12, math.inf, 0.0]),
    # the overflow without the backoff
    "overflow": ("overflow", 0.0, 1e3, [4.0], dict(delta=1e-6, max_steps=12)),
    # eps = NaN without the backoff: the factor 2, never accepted
    "eps_nan": ("poisoned", 0.0, 0.1, [1.0], dict(delta=1e-6, max_steps=9)),
    # eps = NaN with the backoff: h shrinks until |h/(tf - t)| < 1e-11
    "nan_abort": ("poisoned", 0.0, 0.1, [1.0],
                  dict(delta=1e-6, handle_nan=True)),
    # the last step of each leg is trimmed; the next leg continues from
    # the untrimmed estimate
    "trim_continuation": ("decay", 0.0, 0.3, [1.0, 2.0, 3.7],
                          dict(delta=1e-7)),
    # each call stops after max_steps attempts and resumes from its h
    "max_steps": ("decay", 0.0, 0.1, [3.0] * 6,
                  dict(delta=1e-6, max_steps=11, record_trace=8)),
    # more accepted steps than trace slots: the index is clipped
    "trace_clipped": ("decay", 0.0, 0.1, [5.0],
                      dict(delta=1e-8, record_trace=5)),
    "backward": ("decay", 2.0, 0.1, [0.0], dict(delta=1e-8)),
    # the first step is the whole leg
    "prefinished": ("decay", 0.0, 2.0, [0.5, 0.75], dict(delta=1e-2)),
}


def run_port(name, device_loop):
    kind, t0, h0, legs, mp, *script = CASES[name]
    f, y0 = RHS[kind]
    att = ToyAttempt(f, script=script[0] if script else ())
    params = tm.MersonParams(**mp)
    state = tm.merson_init(torch.tensor(y0, dtype=torch.float64), t0, h0)
    out = []
    for tf in legs:
        if device_loop:
            res = tm.merson_solve_device(state, tf, params, att)
        else:
            res = tm.merson_solve(None, state, tf, params, attempt_fn=att)
        state = res[0]
        out.append(res)
    return out


def assert_bitwise(a, b):
    sa, sb = a[0], b[0]
    assert a[1] == b[1]
    assert (sa.t, sa.h, sa.steps, sa.steps_total) == (
        sb.t, sb.h, sb.steps, sb.steps_total)
    assert sa.y.dtype == sb.y.dtype and torch.equal(sa.y, sb.y)
    assert len(a) == len(b)
    if len(a) == 3:
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_loop_equals_host_loop(name):
    host, dev = run_port(name, False), run_port(name, True)
    for a, b in zip(host, dev):
        assert_bitwise(a, b)
    statuses = [r[1] for r in dev]
    final = dev[-1][0]
    # each case reaches the branch it is named for
    if name == "nan_abort":
        assert statuses == [tm.NAN_ABORT]
    elif name == "eps_edges":
        assert statuses == [tm.MAX_STEPS] and final.h == 0.0
        assert final.steps == 4
    elif name in ("eps_edges_backoff", "overflow"):
        assert statuses == [tm.MAX_STEPS] and final.steps > 0
    elif name == "eps_nan":
        assert statuses == [tm.MAX_STEPS] and final.steps == 0
        assert final.h == 0.1 * 2 ** 9
    elif name == "max_steps":
        assert statuses[0] == tm.MAX_STEPS and statuses[-1] == tm.OK
    elif name == "nan_backoff":
        assert statuses == [tm.OK] and final.steps_total > final.steps
    elif name == "trace_clipped":
        assert final.steps > 5 and dev[-1][2][0][-1] == final.t
    else:
        assert set(statuses) == {tm.OK}


# --------------------------------------------------------------------------
# the four freezing attempt paths
# --------------------------------------------------------------------------

SHAPE = (32, 16, 16)     # (n3, n2, n1)


@pytest.fixture(scope="module")
def freezing():
    pf = parse_param_file(freezing_params_text(16, 0),
                          env={"OUTPUT": "unused"})
    prm0 = FreezingParams.from_dict(pf.vars)
    prm = shift_temperature_origin(prm0, prm0.u_star)
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    rng = np.random.default_rng(11)
    w = np.stack([rng.uniform(-3, 3, SHAPE), rng.uniform(0, 1, SHAPE),
                  rng.uniform(0, 0.6, SHAPE)]).astype(np.float32)
    return prm, geom, torch.from_numpy(w)


PATHS = ("delta", "delta_comp", "fused_attempt", "stage")


def _path_solvers(path, prm, geom):
    """(host-loop solve, device-loop solve) of one path, plain versions."""
    if path == "stage":
        stage_fn = st.make_fused_stage(geom, prm, 0, plain=True)
        att = st.StageAttempt(geom, prm, 0, plain=True)
        return (lambda s, tf, p: tm.merson_solve(None, s, tf, p,
                                                 stage_fn=stage_fn),
                lambda s, tf, p: tm.merson_solve_device(s, tf, p, att))
    cls = {"delta": st.DeltaAttempt, "delta_comp": st.DeltaAttemptComp,
           "fused_attempt": st.FusedAttempt}[path]
    host_att, dev_att = (cls(geom, prm, 0, plain=True) for _ in range(2))
    return (lambda s, tf, p: tm.merson_solve(None, s, tf, p,
                                             attempt_fn=host_att),
            lambda s, tf, p: tm.merson_solve_device(s, tf, p, dev_att))


@pytest.mark.parametrize("path", PATHS)
def test_freezing_paths_equal_host_loop(freezing, path):
    """Chunks of 9 attempts with a trace from just below the Dirichlet
    phase switch (D1 and dDi change within the attempts that reach past
    it), then a short leg whose last step is trimmed: every chunk's state,
    t, h, counts, status and trace equal the host loop's bit for bit."""
    prm, geom, y0 = freezing
    host, dev = _path_solvers(path, prm, geom)
    t0 = prm.phase_switch_time - 2e-4
    growth = 1.05 if path == "stage" else 0.0
    params = tm.MersonParams(delta=1e-3, h_min=1e-9, max_steps=9,
                             record_trace=9, handle_nan=True,
                             accept_growth_min=growth)
    sa = sb = tm.merson_init(y0, t0, 1e-4)
    legs = [t0 + 1.0] * 3 + [None]
    for tf in legs:
        if tf is None:       # a leg the next few steps overshoot
            tf = sa.t + 2.5 * sa.h
            params = dataclasses.replace(params, max_steps=100)
        a, b = host(sa, tf, params), dev(sb, tf, params)
        assert_bitwise(a, b)
        sa, sb = a[0], b[0]
    assert a[1] == tm.OK and sb.t > t0 and sb.steps > 0
    # the attempts past the switch were rejected (the top jumps), or the
    # solve crossed it
    assert sb.steps_total > sb.steps or sb.t > prm.phase_switch_time


def test_delta_path_matches_jax_in_chunks():
    """The device loop through DeltaAttempt against the JAX merson_solve
    through its DeltaAttempt in interpret mode, in chunks of 10 attempts:
    equal counts and statuses, t to 1e-2 (see the module docstring)."""
    jprm = default_params()
    prm = params_from_reference(jprm.as_dict())
    shape = (12, 10, 12)
    jgeom = JGeom(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    rng = np.random.RandomState(7)
    w = np.stack([273.15 + 10 * (rng.random_sample(shape) - 0.5),
                  rng.random_sample(shape),
                  0.6 * rng.random_sample(shape)]).astype(np.float32)
    params = dict(delta=1e-3, h_min=1e-9, max_steps=10, record_trace=10)
    pal = jst.make_delta_attempt(jgeom, jprm, 0, bz=2, interpret=True)
    sj = jm.merson_init(jst.pad_state(jnp.asarray(w), jgeom), 0.0, 1e-4)
    sp = tm.merson_init(torch.from_numpy(w), 0.0, 1e-4)
    att = st.DeltaAttempt(geom, prm, 0)
    for _ in range(3):
        sj, status_j, _ = jm.merson_solve(None, sj, 1e9,
                                          jm.MersonParams(**params),
                                          attempt_fn=pal)
        sp, status_p, _ = tm.merson_solve_device(
            sp, 1e9, tm.MersonParams(**params), att)
        assert status_p == int(status_j) == tm.MAX_STEPS
        assert (sp.steps, sp.steps_total) == (int(sj.steps),
                                              int(sj.steps_total))
        assert sp.t == pytest.approx(float(sj.t), rel=1e-2)


# --------------------------------------------------------------------------
# against the JAX controller, in chunks
# --------------------------------------------------------------------------

JAX_RHS = {
    "decay": lambda t, y: -y,
    "stiff": lambda t, y: jnp.stack([-1000.0 * (y[0] - jnp.cos(t)),
                                     y[0] - y[1]]),
    "overflow": lambda t, y: jnp.where(jnp.abs(y) > 100.0, jnp.inf, -y),
}
# h_min is left out: its forced accepts run at the estimate's rounding
# floor, where XLA's and PyTorch's roundings set h apart by more than H_RTOL
JAX_CASES = ("decay", "stiff", "local", "growth_floor", "nan_backoff",
             "trim_continuation", "backward")
CHUNK = 20


@pytest.mark.parametrize("name", JAX_CASES)
def test_device_loop_matches_jax_in_chunks(name):
    """Each leg in chunks of CHUNK attempts with a trace of CHUNK, both
    solvers called again after a MAX_STEPS exit, as the apps' chunked
    branches do: the same counts and statuses chunk by chunk; t, h and the
    traces within T_RTOL and H_RTOL."""
    kind, t0, h0, legs, mp = CASES[name][:5]
    f, y0 = RHS[kind]
    mp = dict(mp, max_steps=CHUNK, record_trace=CHUNK)
    att = ToyAttempt(f)
    jax_solve = jax.jit(functools.partial(
        jm.merson_solve, JAX_RHS[kind], params=jm.MersonParams(**mp)))
    sp = tm.merson_init(torch.tensor(y0, dtype=torch.float64), t0, h0)
    sj = jm.merson_init(jnp.asarray(y0, jnp.float64), t0, h0)
    chunks = 0
    for tf in legs:
        while True:
            prev = sp.steps
            sp, status, (tt, hh) = tm.merson_solve_device(
                sp, tf, tm.MersonParams(**mp), att)
            sj, status_j, (tj, hj) = jax_solve(sj, tf)
            chunks += 1
            assert status == int(status_j)
            assert (sp.steps, sp.steps_total) == (int(sj.steps),
                                                  int(sj.steps_total))
            assert sp.t == pytest.approx(float(sj.t), rel=T_RTOL, abs=1e-300)
            assert sp.h == pytest.approx(float(sj.h), rel=H_RTOL, abs=1e-300)
            n = sp.steps - prev
            np.testing.assert_allclose(tt[:n].numpy(), np.asarray(tj)[:n],
                                       rtol=T_RTOL)
            np.testing.assert_allclose(hh[:n].numpy(), np.asarray(hj)[:n],
                                       rtol=H_RTOL)
            if status != tm.MAX_STEPS:
                break
    assert chunks > len(legs)


# --------------------------------------------------------------------------
# the commit, the growth power and the control block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["copy", "twosum", "flip"])
@pytest.mark.parametrize("accept", [0, 1])
def test_commit_modes(mode, accept):
    rng = np.random.default_rng(5)
    hi, lo, src = (torch.from_numpy(rng.standard_normal((2, 3, 4, 5))
                                    .astype(np.float32)) for _ in range(3))
    lo *= 1e-7
    cur = torch.zeros(1, dtype=torch.int32)
    block = ctl_mod.ControlBlock(torch.device("cpu"),
                                 torch.zeros(1, dtype=torch.float32))
    block.host.accept = accept
    h0, l0 = hi.clone(), lo.clone()
    if mode == "copy":
        ctl_mod.commit(block, ctl_mod.COMMIT_COPY, hi, src=src)
        assert torch.equal(hi, src if accept else h0)
    elif mode == "twosum":
        ctl_mod.commit(block, ctl_mod.COMMIT_TWOSUM, hi, lo, src=src)
        if accept:
            # TwoSum: hi + lo is exactly hi + fl(src + lo)
            exact = h0.double() + (src + l0).double()
            torch.testing.assert_close(hi.double() + lo.double(), exact,
                                       rtol=0, atol=1e-13)
            assert not torch.equal(hi, h0)
        else:
            assert torch.equal(hi, h0) and torch.equal(lo, l0)
    else:
        ctl_mod.commit(block, ctl_mod.COMMIT_FLIP, hi, cur=cur)
        assert int(cur) == accept
    assert block.host.accept == accept


def test_pow_02_is_correctly_rounded():
    """pow_02 against q ** 0.2 (0.2 the double) worked out to 60 digits,
    where the C library's pow misrounds now and then; and its edges."""
    decimal.getcontext().prec = 60
    e = decimal.Decimal(0.2)
    rng = np.random.default_rng(0)
    qs = 10.0 ** rng.uniform(-8, 12, 4000)
    libm_misses = 0
    for q in qs.tolist():
        exact = float((decimal.Decimal(q).ln() * e).exp())
        assert tm.pow_02(q) == exact, q
        libm_misses += q ** 0.2 != exact
    assert libm_misses < 40
    assert tm.pow_02(0.0) == 0.0 and tm.pow_02(1.0) == 1.0
    assert tm.pow_02(32.0) == 2.0 and tm.pow_02(math.inf) == math.inf


def test_control_block_layout_matches_header():
    """The ctypes mirror has the fields of struct Control of
    csrc/control.cuh in the same order, and its size."""
    src = (Path(st.__file__).resolve().parents[2] / "csrc"
           / "control.cuh").read_text()
    body = re.search(r"struct Control \{(.*?)\n\};", src, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        decl = re.sub(r"^(const\s+)?(long\s+long|\w+)\s*\**", "", decl)
        names += [re.sub(r"[\s*]|\[\d+\]", "", n) for n in decl.split(",")]
    assert names == [n for n, _ in ctl_mod.Control._fields_]
    assert ctypes.sizeof(ctl_mod.Control) == 304
