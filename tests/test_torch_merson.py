"""The port's Merson controller (solvers/merson.py, host loop over torch
tensors) against the JAX package's ``merson_solve`` on toy ODEs, in f64:
the same successful and attempted step counts, status, final t and h."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.solvers import merson as jm
from porousfreezethaw_tpu_torch.solvers import merson as tm

torch.set_num_threads(1)


def decay_jax(t, y):
    return -y


def decay_torch(t, y):
    return -y


def stiff_jax(t, y):
    return jnp.stack([-1000.0 * (y[0] - jnp.cos(t)), y[0] - y[1]])


def stiff_torch(t, y):
    return torch.stack([-1000.0 * (y[0] - np.cos(t)), y[0] - y[1]])


def overflow_jax(t, y):
    # inf above |y| = 100: a large h overflows the stage cascade
    return jnp.where(jnp.abs(y) > 100.0, jnp.inf, -y)


def overflow_torch(t, y):
    return torch.where(torch.abs(y) > 100.0, torch.inf, -y)


RHS = {"decay": (decay_jax, decay_torch, [1.0, 2.0, -3.0]),
       "stiff": (stiff_jax, stiff_torch, [0.0, 1.0]),
       "overflow": (overflow_jax, overflow_torch, [1.0, 0.5])}


def run_both(kind, t0, h0, legs, **mp):
    """Solve both controllers over the final times ``legs`` (one call per
    leg, the state carried across) and return the per-leg results."""
    fj, ft, y0 = RHS[kind]
    params_j = jm.MersonParams(**mp)
    params_t = tm.MersonParams(**mp)
    sj = jm.merson_init(jnp.asarray(y0, jnp.float64), t0, h0)
    st = tm.merson_init(torch.tensor(y0, dtype=torch.float64), t0, h0)
    out = []
    for tf in legs:
        rj = jm.merson_solve(fj, sj, tf, params_j)
        rt = tm.merson_solve(ft, st, tf, params_t)
        sj, st = rj[0], rt[0]
        out.append((rj, rt))
    return out


# The counts and statuses must agree exactly.  t and h agree to rounding:
# eps is a cancelling combination (|eps| ~ delta while |K| ~ 1), so a
# one-ulp difference in a stage value, which XLA's fused f64 arithmetic and
# PyTorch's unfused arithmetic may round differently, moves eps by up to
# ~1e-7 relative and the next h by a fifth of that.  h does not drift: the
# growth rule's h^5 error model makes each new h independent of the last
# to first order.
T_RTOL = H_RTOL = 1e-6


def assert_same(rj, rt):
    sj, status_j = rj[0], int(rj[1])
    st, status_t = rt[0], rt[1]
    assert status_t == status_j
    assert st.steps == int(sj.steps)
    assert st.steps_total == int(sj.steps_total)
    assert st.t == pytest.approx(float(sj.t), rel=T_RTOL, abs=1e-300)
    assert st.h == pytest.approx(float(sj.h), rel=H_RTOL, abs=1e-300)
    np.testing.assert_allclose(st.y.numpy(), np.asarray(sj.y), rtol=1e-6,
                               atol=1e-12)


CASES = {
    "decay": dict(kind="decay", t0=0.0, h0=0.1, legs=[5.0],
                  mp=dict(delta=1e-8)),
    "stiff": dict(kind="stiff", t0=0.0, h0=1e-3, legs=[0.5],
                  mp=dict(delta=1e-5)),
    "stiff_local": dict(kind="stiff", t0=0.0, h0=1e-3, legs=[0.5],
                        mp=dict(delta=1e-7, delta_mode="local")),
    "accept_growth_min": dict(kind="stiff", t0=0.0, h0=1e-3, legs=[0.5],
                              mp=dict(delta=1e-5, accept_growth_min=1.05)),
    # delta below the reachable error: |h| < h_min forces the accepts
    "h_min": dict(kind="decay", t0=0.0, h0=0.1, legs=[2.0],
                  mp=dict(delta=1e-10, h_min=0.05)),
    "handle_nan": dict(kind="overflow", t0=0.0, h0=1e3, legs=[4.0],
                       mp=dict(delta=1e-6, handle_nan=True)),
    # the final step is trimmed to the leg's end; the next leg continues
    # from the untrimmed estimate
    "trim_continuation": dict(kind="decay", t0=0.0, h0=0.3,
                              legs=[1.0, 2.0, 3.7], mp=dict(delta=1e-7)),
    "backward": dict(kind="decay", t0=2.0, h0=0.1, legs=[0.0],
                     mp=dict(delta=1e-8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_controller_matches_jax(name):
    c = CASES[name]
    for rj, rt in run_both(c["kind"], c["t0"], c["h0"], c["legs"], **c["mp"]):
        assert_same(rj, rt)
    if name == "handle_nan":
        # the backoff really ran: the first attempts were rejected
        st = rt[0]
        assert st.steps_total > st.steps


def test_max_steps_resumes_from_working_h():
    """max_steps bounds the attempts of one call; the MAX_STEPS exit
    carries the working h, and resumed calls finish like JAX's."""
    legs = [5.0] * 4
    res = run_both("decay", 0.0, 0.1, legs, delta=1e-8, max_steps=40)
    statuses = [r[1] for _, r in res]
    assert statuses[0] == tm.MAX_STEPS
    assert tm.OK in statuses
    for rj, rt in res:
        assert_same(rj, rt)


def test_service_callback_interrupts():
    """A nonzero service return interrupts after that accepted step with
    status INTERRUPTED; the calls seen match JAX's host callback."""
    calls_j, calls_t = [], []

    def svc_j(t, h, steps):
        calls_j.append((t, h, steps))
        return int(steps == 7)

    def svc_t(t, h, steps):
        calls_t.append((t, h, steps))
        return int(steps == 7)

    params_j = jm.MersonParams(delta=1e-8)
    params_t = tm.MersonParams(delta=1e-8)
    sj, status_j = jm.merson_solve(
        decay_jax, jm.merson_init(jnp.asarray([1.0, 2.0], jnp.float64), 0.0,
                                  0.1), 5.0, params_j, service_callback=svc_j)
    st, status_t = tm.merson_solve(
        decay_torch, tm.merson_init(torch.tensor([1.0, 2.0],
                                                 dtype=torch.float64), 0.0,
                                    0.1), 5.0, params_t,
        service_callback=svc_t)
    assert status_t == int(status_j) == tm.INTERRUPTED
    assert [c[2] for c in calls_t] == [c[2] for c in calls_j]
    np.testing.assert_allclose(np.array(calls_t)[:, :2],
                               np.array(calls_j)[:, :2], rtol=T_RTOL)
    assert_same((sj, status_j), (st, status_t))


def test_record_trace_matches_jax():
    params = dict(delta=1e-8, record_trace=16)
    y0 = [1.0, 2.0]
    sj, status_j, (tj, hj) = jm.merson_solve(
        decay_jax, jm.merson_init(jnp.asarray(y0, jnp.float64), 0.0, 0.1),
        5.0, jm.MersonParams(**params))
    st, status_t, (tt, ht) = tm.merson_solve(
        decay_torch, tm.merson_init(torch.tensor(y0, dtype=torch.float64),
                                    0.0, 0.1),
        5.0, tm.MersonParams(**params))
    assert_same((sj, status_j), (st, status_t))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=T_RTOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=H_RTOL)


def test_state_from_reference_continues_a_jax_solve():
    """A JAX MersonState carried across with convert.state_from_reference
    continues in the port as it continues in JAX (f64 freezing RHS)."""
    from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
    from porousfreezethaw_tpu.models.freezing import make_rhs as jax_make_rhs
    from porousfreezethaw_tpu_torch.convert import (
        params_from_reference, state_from_reference)
    from porousfreezethaw_tpu_torch.core.grid import GridGeometry
    from porousfreezethaw_tpu_torch.models.freezing import make_rhs
    from tests.test_freezing_equation import default_params

    shape = (8, 6, 5)
    jprm = default_params()
    jgeom = JGeom(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    rng = np.random.default_rng(5)
    w = np.stack([273.15 + 2 * (rng.random(shape) - 0.5), rng.random(shape),
                  0.6 * rng.random(shape)])
    params = dict(delta=1e-3, h_min=1e-9)
    jrhs = jax_make_rhs(jgeom, jprm, calc_mode=0)
    sj, _ = jm.merson_solve(jrhs, jm.merson_init(jnp.asarray(w), 0.0, 1e-4),
                            2e-3, jm.MersonParams(**params))
    st = state_from_reference(np.asarray(sj.y), sj.t, sj.h, sj.steps,
                              sj.steps_total, "cpu")
    assert st.y.dtype == torch.float64 and st.steps == int(sj.steps)
    rhs = make_rhs(geom, params_from_reference(jprm.as_dict()), 0, "cpu")
    rj = jm.merson_solve(jrhs, sj, 4e-3, jm.MersonParams(**params))
    rt = tm.merson_solve(rhs, st, 4e-3, tm.MersonParams(**params))
    assert_same(rj, rt)
    assert rt[0].steps > st.steps
