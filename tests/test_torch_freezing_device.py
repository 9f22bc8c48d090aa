"""The plain-RHS freezing solve on the device-resident Merson loop
(``models/freezing/attempt.py`` ``PlainAttempt`` through
``merson_solve_device``), with the plain versions of its control and
commit kernels on the CPU, against the host loop (``merson_solve``) bit
for bit and against the JAX package's ``merson_solve`` over its f64
``make_rhs``.

* The device loop against the host loop at 8x8x16, in chunks of
  ``max_steps`` with a trace, from just below ``phase_switch_time``
  across it, then a short leg whose last step is trimmed: f64 in calc
  modes 0/1/2/10/11 and f32 with a noise field (NaN backoff on, growth
  floor 1.05, as the app runs it); state, t, h, counts, status and trace
  bit for bit.
* Against JAX (f64, calc modes 0/1/2/10/11, chunks of 12 attempts):
  equal counts and statuses chunk by chunk, the state to 1e-12 of
  max|JAX|, t and h within tests/test_torch_merson.py's T_RTOL and
  H_RTOL, on windows where the right-hand side's last bits do not set the
  steps (``test_f64_counts_equal_jax``).
* Chunks of a call through ``between`` give one call's bits, also where
  new calls after ``MAX_STEPS`` exits lose the untrimmed continuation h.
* The control block's float64 stage times equal the host loop's Python
  floats; the right-hand side given t as a 0-d float64 tensor equals the
  one given the host float, bit for bit, on each side of the switch and
  where float32 rounding moves t across it; a host float keeps the host
  path's bits.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.models.freezing import make_rhs as jax_make_rhs
from porousfreezethaw_tpu.solvers import merson as jm
from porousfreezethaw_tpu_torch.convert import params_from_reference
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing import physics
from porousfreezethaw_tpu_torch.models.freezing.attempt import PlainAttempt
from porousfreezethaw_tpu_torch.models.freezing.equation import (
    DirichletTop, dirichlet_at, make_noise_field, make_rhs)
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    shift_temperature_origin)
from porousfreezethaw_tpu_torch.ops.cuda import control as ctl_mod
from porousfreezethaw_tpu_torch.solvers import merson as tm
from tests.test_freezing_equation import default_params
from tests.test_torch_merson import H_RTOL, T_RTOL

torch.set_num_threads(1)

SHAPE = (16, 8, 8)       # (n3, n2, n1)
L = (0.03, 0.03, 0.06)


def geometry(cls=GridGeometry):
    return cls(*L, SHAPE[2], SHAPE[1], SHAPE[0])


def state(seed, u_star):
    """(3, n3, n2, n1) float64: u about u_star, p in [0, 1], gl in
    [0, 0.6]."""
    rng = np.random.default_rng(seed)
    return np.stack([u_star + 6.0 * (rng.random(SHAPE) - 0.5),
                     rng.random(SHAPE), 0.6 * rng.random(SHAPE)])


def case(name):
    """(rhs, initial state, MersonParams keywords, params) of a case:
    'f64_<mode>' or 'noise_f32' (GradP, u stored as u - u*, as the app
    runs f32)."""
    prm = params_from_reference(default_params().as_dict())
    geom = geometry()
    if name == "noise_f32":
        prm = shift_temperature_origin(prm, prm.u_star)
        noisy = dataclasses.replace(prm, u_noise_amp=0.5)
        noise = make_noise_field(geom, noisy, seed=3, dtype=np.float32)
        rhs = make_rhs(geom, prm, 0, "cpu", noise=noise)
        y0 = torch.from_numpy(state(1, 0.0).astype(np.float32))
        return rhs, y0, dict(handle_nan=True, accept_growth_min=1.05), prm
    mode = int(name.split("_")[1])
    rhs = make_rhs(geom, prm, mode, "cpu")
    return rhs, torch.from_numpy(state(1, prm.u_star)), {}, prm


def assert_bitwise(a, b):
    (sa, status_a, tr_a), (sb, status_b, tr_b) = a, b
    assert status_a == status_b
    assert (sa.t, sa.h, sa.steps, sa.steps_total) == (
        sb.t, sb.h, sb.steps, sb.steps_total)
    assert sa.y.dtype == sb.y.dtype and torch.equal(sa.y, sb.y)
    assert all(torch.equal(x, y) for x, y in zip(tr_a, tr_b))


CASES = ("f64_0", "f64_1", "f64_2", "f64_10", "f64_11", "noise_f32")


@pytest.mark.parametrize("name", CASES)
def test_device_loop_equals_host_loop(name):
    """Chunks of 10 attempts with a trace from 0.01 s below the switch of
    the Dirichlet top, which the solve crosses (the top's jump is rejected
    down to the shipped tau_min, 1e-6, whose forced accepts cross it); then
    a leg the next steps overshoot, whose last step is trimmed."""
    rhs, y0, kw, prm = case(name)
    att = PlainAttempt(rhs, SHAPE, y0.dtype)
    t0 = prm.phase_switch_time - 1e-2
    params = tm.MersonParams(delta=1e-3, h_min=1e-6, max_steps=10,
                             record_trace=10, **kw)
    sa = sb = tm.merson_init(y0, t0, 1e-6)
    for tf in [t0 + 1.0] * 4 + [None]:
        if tf is None:
            tf = sa.t + 2.5 * sa.h
            params = tm.MersonParams(delta=1e-3, h_min=1e-6,
                                     max_steps=100, record_trace=10, **kw)
        a = tm.merson_solve(rhs, sa, tf, params)
        b = tm.merson_solve_device(sb, tf, params, att)
        assert_bitwise(a, b)
        sa, sb = a[0], b[0]
    assert a[1] == tm.OK and sb.t == tf and sb.steps >= 10
    # the top, decided at the field precision, switched within the window
    # (in float32 once t rounds to the switch time)
    assert dirichlet_at(t0, prm, y0.dtype) == dirichlet_at(0.0, prm,
                                                          y0.dtype)
    assert dirichlet_at(sb.t, prm, y0.dtype) == dirichlet_at(
        prm.phase_switch_time, prm, y0.dtype)
    assert torch.isfinite(sb.y).all()


def test_chunks_through_between_equal_one_call():
    """merson_solve_device in chunks of k attempts through ``between``
    equals one host-loop call to tf bit for bit (state, t, h, counts and
    the drained trace) for every k up to the call's attempts, among them
    chunks that end between the step that trims the last one and the last
    step; new calls after MAX_STEPS exits lose the untrimmed continuation
    h there."""
    rhs, y0, _, prm = case("f64_11")
    att = PlainAttempt(rhs, SHAPE, torch.float64)
    tf = 6.0
    ref, status, _ = tm.merson_solve(
        rhs, tm.merson_init(y0, 0.0, 1e-3), tf,
        tm.MersonParams(delta=1e-3, record_trace=64))
    assert status == tm.OK and ref.steps_total > 8
    trace = []
    lost = 0
    for k in range(1, ref.steps_total + 1):
        params = tm.MersonParams(delta=1e-3, max_steps=k, record_trace=k)
        trace.clear()

        def between(tt, hh, n, steps):
            assert steps == len(trace)
            trace.extend(zip(tt[:n].tolist(), hh[:n].tolist()))
            return False

        st, status, _ = tm.merson_solve_device(
            tm.merson_init(y0, 0.0, 1e-3), tf, params, att, between=between)
        assert status == tm.OK and len(trace) == st.steps
        assert (st.t, st.h, st.steps, st.steps_total) == (
            ref.t, ref.h, ref.steps, ref.steps_total)
        assert torch.equal(st.y, ref.y)
        again = tm.merson_init(y0, 0.0, 1e-3)
        while True:
            again, status, _ = tm.merson_solve_device(again, tf, params, att)
            if status != tm.MAX_STEPS:
                break
        lost += again.h != ref.h
    assert lost >= 1


def smooth_state(u_star):
    """(3, n3, n2, n1) float64 of smooth fields: u rising with z about
    u_star, a p front across z, one glass bump."""
    z, y, x = np.meshgrid(*(np.linspace(0, 1, n) for n in SHAPE),
                          indexing="ij")
    u = u_star - 4.0 + 6.0 * z + 0.5 * np.sin(3 * x + 2 * y)
    p = 0.5 + 0.45 * np.tanh(4 * (0.5 - z) + np.cos(5 * x) * np.sin(4 * y))
    gl = 0.3 * np.exp(-8 * ((x - 0.5) ** 2 + (y - 0.4) ** 2 + (z - 0.5) ** 2))
    return np.stack([u, p, gl])


# (calc mode, chunks of 12 attempts): the windows in which the last bits of
# the right-hand side do not set the step sequence (see the docstring)
JAX_WINDOWS = ((0, 3), (1, 3), (2, 1), (10, 3), (11, 3))


@pytest.mark.parametrize("mode,chunks", JAX_WINDOWS,
                         ids=[str(m) for m, _ in JAX_WINDOWS])
def test_f64_counts_equal_jax(mode, chunks):
    """The device loop against the JAX merson_solve over its f64 make_rhs
    on the same numpy state, in chunks of 12 attempts with a trace (each
    after a MAX_STEPS exit), from h0 = 0.3: equal counts and statuses,
    the state to 1e-12 of max|JAX|, t, h and the traces within T_RTOL and
    H_RTOL.

    The windows are where the step sequence does not hang on the
    right-hand side's last bits, which XLA and PyTorch round apart (the
    right-hand sides agree to 1e-12, tests/test_torch_equation.py).  From
    h0 = 1e-4, eps starts at its rounding floor (about 6e-14 against K of
    about 10) and each framework's rounding picks the next steps: t and h
    then part by up to 3e-4 relative over 36 attempts, with equal counts.
    In calc mode 2 (Temp), the second chunk's rejections part t by 5e-6
    and the state by 2e-8."""
    jprm = default_params()
    prm = params_from_reference(jprm.as_dict())
    w = smooth_state(prm.u_star)
    jrhs = jax_make_rhs(geometry(JGeom), jprm, calc_mode=mode)
    att = PlainAttempt(make_rhs(geometry(), prm, mode, "cpu"), SHAPE,
                       torch.float64)
    mp = dict(delta=1e-3, h_min=1e-9, max_steps=12, record_trace=12)
    jax_solve = jax.jit(lambda s: jm.merson_solve(
        jrhs, s, 1e9, jm.MersonParams(**mp)))
    sj = jm.merson_init(jnp.asarray(w), 0.0, 0.3)
    sp = tm.merson_init(torch.from_numpy(w), 0.0, 0.3)
    for _ in range(chunks):
        prev = sp.steps
        sp, status, (tt, hh) = tm.merson_solve_device(
            sp, 1e9, tm.MersonParams(**mp), att)
        sj, status_j, (tj, hj) = jax_solve(sj)
        assert status == int(status_j) == tm.MAX_STEPS
        assert (sp.steps, sp.steps_total) == (int(sj.steps),
                                              int(sj.steps_total))
        assert sp.t == pytest.approx(float(sj.t), rel=T_RTOL)
        assert sp.h == pytest.approx(float(sj.h), rel=H_RTOL)
        ref = np.asarray(sj.y)
        err = np.abs(sp.y.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-12
        n = sp.steps - prev
        np.testing.assert_allclose(tt[:n].numpy(), np.asarray(tj)[:n],
                                   rtol=T_RTOL)
        np.testing.assert_allclose(hh[:n].numpy(), np.asarray(hj)[:n],
                                   rtol=H_RTOL)
    assert sp.steps >= 9


def test_block_stage_times_are_the_host_loops_floats():
    """The block's ts64 (through its 0-d views) equal t, t + h/3, t + h/2
    and t + h as the host loop forms them, over random (t, h) of both
    signs and magnitudes."""
    rng = np.random.default_rng(12)
    block = ctl_mod.ControlBlock(torch.device("cpu"),
                                 torch.zeros(1, dtype=torch.float64))
    ts = 10.0 ** rng.uniform(-6, 5, 1000) * rng.choice([-1, 1], 1000)
    hs = 10.0 ** rng.uniform(-9, 2, 1000) * rng.choice([-1, 1], 1000)
    for t, h in zip(ts.tolist(), hs.tolist()):
        c = ctl_mod.Control(t=t, h=h)
        ctl_mod.next_scalars_plain(c)
        block.write(c)
        h2, h3 = h / 2, h / 3
        want = [t, t + h3, t + h2, t + h]
        assert list(c.ts64) == want
        assert [float(v) for v in block.ts64] == want
        assert all(v.dim() == 0 and v.dtype == torch.float64
                   for v in block.ts64)


def _switch_times(prm):
    """Times about the switch: either side in float64, and float64 values
    below it that round to float32 at or above the float32 switch."""
    sw = prm.phase_switch_time
    s32 = float(np.float32(sw))
    out = [0.0, sw, math.nextafter(sw, 0.0), math.nextafter(sw, math.inf),
           sw - 1e-3, sw + 1e-3, s32, math.nextafter(s32, 0.0), 1e9]
    lo32 = float(np.nextafter(np.float32(s32), np.float32(0.0)))
    # the float32 midpoint below s32 rounds up to it (ties to even, or
    # just above the midpoint)
    out += [0.5 * (lo32 + s32), math.nextafter(0.5 * (lo32 + s32),
                                               math.inf)]
    return out


def test_dirichlet_top_of_a_tensor_time():
    """DirichletTop on a 0-d float64 t decides the top as dirichlet_at on
    the host float, in each field dtype, with the value in that dtype;
    and some float64 t below the switch take the second value in
    float32."""
    prm = params_from_reference(default_params().as_dict())
    top = DirichletTop(prm, torch.device("cpu"))
    moved = 0
    for t in _switch_times(prm):
        for dt in (torch.float32, torch.float64):
            got = top(torch.tensor(t, dtype=torch.float64), dt)
            assert got.dim() == 0 and got.dtype == dt
            assert float(got) == dirichlet_at(t, prm, dt)
        moved += (physics.dirichlet_top(t, prm)
                  != physics.dirichlet_top_f32(t, prm))
    assert moved >= 1


@pytest.mark.parametrize("name", ["f64_0", "f64_2", "noise_f32"])
def test_tensor_time_equals_host_float(name):
    """rhs(t, w) with t a 0-d float64 tensor equals rhs(t, w) with the
    host float bit for bit, at times on each side of the switch; and the
    host float keeps the host path's bits: its top is dirichlet_at's
    (the u-equation at a time past the switch differs from one before
    it, by the top's jump alone)."""
    rhs, y0, _, prm = case(name)
    for t in _switch_times(prm):
        a = rhs(t, y0)
        b = rhs(torch.tensor(t, dtype=torch.float64), y0)
        assert a.dtype == y0.dtype and torch.equal(a, b)
    before = rhs(prm.phase_switch_time - 1.0, y0)
    after = rhs(prm.phase_switch_time + 1.0, y0)
    changed = (before != after).any(dim=(1, 2, 3))
    assert bool(changed[0]) and not bool(changed[2])
    diff = (before[0] != after[0]).nonzero()[:, 0].unique()
    assert diff.tolist() == [SHAPE[0] - 1]


def test_plain_attempt_refuses_a_foreign_state():
    rhs, y0, _, _ = case("f64_0")
    att = PlainAttempt(rhs, SHAPE, torch.float64)
    params = tm.MersonParams(delta=1e-3, max_steps=2)
    for bad in (y0.float(), y0[:, 1:], {"u": y0}):
        with pytest.raises(ValueError, match="PlainAttempt expects"):
            tm.merson_solve_device(tm.merson_init(bad, 0.0, 1e-6), 1.0,
                                   params, att)
