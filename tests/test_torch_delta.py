"""The port's increment form and the plain versions of its two CUDA
kernels against the JAX package: the plain ``make_g_rhs`` against JAX
``make_g_rhs`` (f64), the plain stage and delta kernels against the JAX
Pallas kernels in interpret mode (f32, through pad_state/unpad_state), and
a whole plain ``DeltaAttempt`` against the JAX ``DeltaAttempt``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.models.freezing.delta import (
    make_g_rhs as jax_make_g_rhs)
from porousfreezethaw_tpu.ops.pallas import stencil as jst
from porousfreezethaw_tpu_torch.convert import params_from_reference
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing import physics
from porousfreezethaw_tpu_torch.models.freezing.delta import (
    TorchDeltaAttempt, make_g_rhs)
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from tests.test_freezing_equation import default_params

torch.set_num_threads(1)

MODES = [0, 1, 2, 10, 11]
SHAPE = (14, 10, 12)     # (n3, n2, n1)


@pytest.fixture(scope="module")
def case():
    jprm = default_params()
    prm = params_from_reference(jprm.as_dict())
    jgeom = JGeom(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    rng = np.random.default_rng(7)
    w = np.stack([273.15 + 10 * (rng.random(SHAPE) - 0.5),
                  rng.random(SHAPE), 0.6 * rng.random(SHAPE)])
    ks = rng.standard_normal((3, 2) + SHAPE)
    return jprm, prm, jgeom, geom, w, ks


def _scaled_close(got, want, atol):
    """The tolerance of tests/test_delta_form.py: |got - want| / s <= atol
    with s = max(|want|, 1e-3)."""
    scale = np.maximum(np.abs(want), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", MODES)
def test_g_rhs_f64_matches_jax(case, mode):
    jprm, prm, jgeom, geom, w, ks = case
    jg = jax_make_g_rhs(jgeom, jprm, calc_mode=mode)
    g = make_g_rhs(geom, prm, mode)
    for h in (1e-3, 1e-1, 10.0):
        d = h * ks[0]
        t1, ti = 100.0, 100.0 + h
        want = np.asarray(jg(t1, ti, jnp.asarray(w), jnp.asarray(d)))
        got = g(t1, ti, torch.from_numpy(w), torch.from_numpy(d)).numpy()
        _scaled_close(got, want, 1e-9)


def test_g_rhs_dirichlet_switch_step(case):
    """A stage crossing phase_switch_time: increment ghost D(ti) - D(t1)."""
    jprm, prm, jgeom, geom, w, ks = case
    jg = jax_make_g_rhs(jgeom, jprm, calc_mode=0)
    g = make_g_rhs(geom, prm, 0)
    d = 1e-2 * ks[0]
    t1, ti = prm.phase_switch_time - 1.0, prm.phase_switch_time + 1.0
    want = np.asarray(jg(t1, ti, jnp.asarray(w), jnp.asarray(d)))
    got = g(t1, ti, torch.from_numpy(w), torch.from_numpy(d)).numpy()
    _scaled_close(got, want, 1e-9)
    # the switch really entered: the top plane differs from a same-phase step
    same = g(t1, t1 + 0.5, torch.from_numpy(w), torch.from_numpy(d)).numpy()
    assert np.abs(got[0, -1] - same[0, -1]).max() > 1.0


# --------------------------------------------------------------------------
# plain kernel versions vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

STAGE_CASES = [([], False), ([1 / 3], False), ([1 / 6, 1 / 6], False),
               ([1 / 8, 3 / 8, 0.25], False), ([0.5, -1.5, 2.0], True)]
DELTA_CASES = [([1 / 3], False), ([1 / 3, 1 / 6], False),
               ([0.5, 0.375, 0.25], False), ([1.0, -1.5, 2.0], True)]


def _f32_case(case, shifted):
    jprm, prm, jgeom, geom, w, ks = case
    w32 = w.astype(np.float32)
    if shifted:   # the production state: u - u* with the shifted params
        from porousfreezethaw_tpu.models.freezing.parameters import (
            shift_temperature_origin as jshift)
        from porousfreezethaw_tpu_torch.models.freezing.parameters import (
            shift_temperature_origin)
        w32[0] -= np.float32(jprm.u_star)
        jprm = jshift(jprm, jprm.u_star)
        prm = shift_temperature_origin(prm, prm.u_star)
    return jprm, prm, jgeom, geom, w32, ks.astype(np.float32)


def _close_k(got, want):
    """K/G and y_spec: rtol 1e-5 with an absolute floor of 1e-5 of the
    largest |value| (float32 sums taken in other orders and with other
    multiply-add contractions)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _close_eps(got, want):
    """eps: relative 1e-3 + 1e-7 absolute (tests/test_delta_form.py)."""
    assert abs(got - want) <= 1e-3 * abs(want) + 1e-7, (got, want)


def test_plain_stage_matches_pallas(case):
    """The plain fused stage (nk 0-3 and stage5) against JAX
    make_fused_stage in interpret mode, GradP, after the phase switch;
    before the switch only the top plane's du changes."""
    jprm, prm, jgeom, geom, w32, ks = _f32_case(case, shifted=False)
    t = prm.phase_switch_time + 1.0
    jstage = jst.make_fused_stage(jgeom, jprm, 0, bz=2, interpret=True)
    spec = st.StencilSpec.of(geom, prm, 0)
    wp = jst.pad_state(jnp.asarray(w32), jgeom)
    kp = [jst.pad_state(jnp.asarray(k), jgeom) for k in ks]
    w_t = torch.from_numpy(w32)
    k_t = [torch.from_numpy(k) for k in ks]
    h = 0.05
    for cs, s5 in STAGE_CASES:
        jks = list(zip(cs, kp))
        tks = list(zip(cs, k_t))
        if s5:
            y_p, eps_p = jstage.stage5(t, h, wp, jks)
            y, eps = st.fused_stage(spec, t, h, w_t, tks, stage5=True)
            _close_k(y.numpy(), jst.unpad_state(y_p, jgeom))
            _close_eps(float(eps.max()), float(jnp.max(eps_p)))
        else:
            k = st.fused_stage(spec, t, h, w_t, tks)
            _close_k(k.numpy(), jst.unpad_state(jstage(t, h, wp, jks), jgeom))
    # the Dirichlet value is decided on t rounded to float32
    t_before = float(np.nextafter(np.float32(prm.phase_switch_time),
                                  np.float32(0)))
    after = st.fused_stage(spec, t, h, w_t, [])
    before = st.fused_stage(spec, t_before, h, w_t, [])
    diff = (after - before).abs()
    assert diff[0, -1].min() > 0
    assert diff[0, :-1].max() == 0 and diff[1].max() == 0


# mode 1 here; modes 0 and 2 run through the delta kernel in the whole
# attempt below
@pytest.mark.parametrize("mode", [1])
def test_plain_delta_g_matches_pallas(case, mode):
    """The plain delta kernel (nk 1-3 and stage5) against JAX make_delta_g
    in interpret mode, with the increment ghost of a step across the
    phase switch."""
    jprm, prm, jgeom, geom, w32, ks = _f32_case(case, shifted=True)
    jg = jst.make_delta_g(jgeom, jprm, mode, bz=2, interpret=True)
    spec = st.StencilSpec.of(geom, prm, mode)
    wp = jst.pad_state(jnp.asarray(w32), jgeom)
    kp = [jst.pad_state(jnp.asarray(k), jgeom) for k in ks]
    w_t = torch.from_numpy(w32)
    k_t = [torch.from_numpy(k) for k in ks]
    h = 0.05
    t = prm.phase_switch_time - 0.5 * h
    D1 = physics.dirichlet_top(t, prm)
    dDi = float(np.float32(physics.dirichlet_top(t + h, prm) - D1))
    assert dDi != 0.0
    for cs, s5 in DELTA_CASES:
        jks = list(zip(cs, kp))
        tks = list(zip(cs, k_t))
        if s5:
            y_p, eps_p = jg(h, D1, dDi, wp, jks, stage5=True)
            y, eps = st.delta_g(spec, h, D1, dDi, w_t, tks, stage5=True)
            _close_k(y.numpy(), jst.unpad_state(y_p, jgeom))
            _close_eps(float(eps.max()), float(jnp.max(eps_p)))
        else:
            g = st.delta_g(spec, h, D1, dDi, w_t, tks)
            _close_k(g.numpy(), jst.unpad_state(jg(h, D1, dDi, wp, jks),
                                                jgeom))


@pytest.mark.parametrize("mode", [0, 2])
def test_plain_delta_attempt_matches_pallas(case, mode):
    """One whole plain DeltaAttempt against the JAX DeltaAttempt in
    interpret mode, and against the port's TorchDeltaAttempt (the
    analog of XlaDeltaAttempt), with the tolerances of
    tests/test_delta_form.py."""
    jprm, prm, jgeom, geom, w32, _ = _f32_case(case, shifted=True)
    t, h = 100.0, 0.05
    jatt = jst.make_delta_attempt(jgeom, jprm, mode, bz=2, interpret=True)
    (_, spec_p), eps_p = jatt.attempt(jnp.asarray(t, jnp.float64),
                                      jnp.asarray(h, jnp.float64),
                                      jst.pad_state(jnp.asarray(w32), jgeom))
    want_y = np.asarray(jst.unpad_state(spec_p, jgeom))
    want_eps = float(jnp.max(eps_p))

    att = st.DeltaAttempt(geom, prm, mode)
    y = att.pack(torch.from_numpy(w32))
    (_, y_spec), eps_blocks = att.attempt(t, h, y)
    np.testing.assert_allclose(y_spec.numpy(), want_y, rtol=1e-5, atol=1e-5)
    _close_eps(float(eps_blocks.max()), want_eps)

    tatt = TorchDeltaAttempt(geom, prm, mode, "cpu")
    (_, y_x), eps_x = tatt.attempt(t, h, torch.from_numpy(w32))
    np.testing.assert_allclose(y_spec.numpy(), y_x.numpy(), rtol=1e-5,
                               atol=1e-5)
    _close_eps(float(eps_blocks.max()), float(eps_x.max()))

    # commit writes (u, p) in place and leaves gl
    gl = y[2].clone()
    out = att.commit((y, y_spec), True)
    assert out is y
    assert torch.equal(out[:2], y_spec) and torch.equal(out[2], gl)


def test_wrappers_reject_bad_inputs(case):
    jprm, prm, jgeom, geom, w32, ks = _f32_case(case, shifted=True)
    spec = st.StencilSpec.of(geom, prm, 0)
    w_t = torch.from_numpy(w32)
    k = torch.from_numpy(ks[0])
    with pytest.raises(TypeError):
        st.fused_stage(spec, 0.0, 0.1, w_t.double(), [])
    with pytest.raises(ValueError):
        st.fused_stage(spec, 0.0, 0.1, w_t[:, :-1].contiguous(), [])
    with pytest.raises(ValueError):
        st.delta_g(spec, 0.1, 0.0, 0.0, w_t, [])           # nk >= 1
    with pytest.raises(ValueError):
        st.delta_g(spec, 0.1, 0.0, 0.0, w_t, [(1.0, k)], stage5=True)
    with pytest.raises(ValueError):
        st.fused_stage(spec, 0.0, 0.1, w_t, [(1.0, k.transpose(2, 3))])
    # the CPU path computes with the plain version and counts no launch
    before = (st.fused_stage.launches, st.delta_g.launches)
    st.fused_stage(spec, 0.0, 0.1, w_t, [])
    st.delta_g(spec, 0.1, 0.0, 0.0, w_t, [(1.0, k)])
    assert (st.fused_stage.launches, st.delta_g.launches) == before
