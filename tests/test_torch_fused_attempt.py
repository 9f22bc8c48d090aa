"""The port's double-buffered attempt (``FusedAttempt``, the plain version
of the ``fused_attempt`` kernel on the CPU) against the JAX
``FusedAttempt`` in interpret mode (through pad_state/unpad_state),
against the port's own ``fused_stage`` stage-5 chain, and in a 30-attempt
``merson_solve`` against the stage path, as tests/test_pallas_stencil.py
does for the JAX package.

Tolerances: against JAX, y_spec to rtol 1e-5 / atol 1e-6 and eps to 1e-3
relative plus 4 float32 ulps of max|K1| (float32 sums in other orders; the
classic estimate cancels K's of that size); against the port's own stage
chain, bit for bit (the same arithmetic with other state plumbing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.ops.pallas import stencil as jst
from porousfreezethaw_tpu_torch.convert import params_from_reference
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from porousfreezethaw_tpu_torch.solvers import merson as tm
from tests.test_freezing_equation import default_params

torch.set_num_threads(1)

SHAPE = (12, 10, 20)     # (n3, n2, n1), the case of test_pallas_stencil.py
T, H = 100.0, 1e-3


@pytest.fixture(scope="module")
def case():
    jprm = default_params()
    prm = params_from_reference(jprm.as_dict())
    jgeom = JGeom(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    rng = np.random.RandomState(3)
    w = np.stack([273.15 + 10 * (rng.random_sample(SHAPE) - 0.5),
                  rng.random_sample(SHAPE),
                  0.6 * rng.random_sample(SHAPE)]).astype(np.float32)
    return jprm, prm, jgeom, geom, w


def stage_chain(spec, w):
    """The fused_stage chain of one attempt on ``w``: (y_spec, eps)."""
    K1 = st.fused_stage(spec, T, H, w, [])
    K2 = st.fused_stage(spec, T + H / 3, H, w, [(1.0 / 3.0, K1)])
    K3 = st.fused_stage(spec, T + H / 3, H, w,
                        [(1.0 / 6.0, K1), (1.0 / 6.0, K2)])
    K4 = st.fused_stage(spec, T + H / 2, H, w,
                        [(1.0 / 8.0, K1), (3.0 / 8.0, K3)])
    return st.fused_stage(spec, T + H, H, w,
                          [(0.5, K1), (-1.5, K3), (2.0, K4)], stage5=True)


def test_matches_jax_fused_attempt(case):
    """On the production state u - u* at h = 0.05, where the classic
    estimate sits well above its float32 rounding floor."""
    from porousfreezethaw_tpu.models.freezing.parameters import (
        shift_temperature_origin as jshift)
    from porousfreezethaw_tpu_torch.models.freezing.parameters import (
        shift_temperature_origin)
    jprm, prm, jgeom, geom, w = case
    w = w.copy()
    w[0] -= np.float32(jprm.u_star)
    jprm, prm = jshift(jprm, jprm.u_star), shift_temperature_origin(
        prm, prm.u_star)
    h = 0.05
    jatt = jst.make_fused_attempt(jgeom, jprm, 0, bz=4, interpret=True)
    jcarry = jatt.pack(jst.pad_state(jnp.asarray(w), jgeom))
    jspec, jeps = jatt.attempt(T, h, jcarry)
    want = np.asarray(jst.unpad_state(
        jatt.unpack(jatt.commit(jspec, jnp.asarray(True))), jgeom))

    att = st.make_fused_attempt(geom, prm, 0)
    carry = att.pack(torch.from_numpy(w))
    carry_spec, eps = att.attempt(T, h, carry)
    got = att.unpack(att.commit(carry_spec, True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    a, b = float(eps.max()), float(jnp.max(jeps))
    K1 = st.fused_stage(st.StencilSpec.of(geom, prm, 0), T, h,
                        torch.from_numpy(w), [])
    ulp = float(np.spacing(np.float32(K1.abs().max())))
    assert abs(a - b) <= 1e-3 * max(a, b) + 4 * ulp, (a, b, ulp)


def test_equals_stage5_chain(case):
    """Bit for bit the fused_stage chain; accept flips the slot on the
    device, reject keeps it, and both slots keep gl."""
    jprm, prm, jgeom, geom, w = case
    spec = st.StencilSpec.of(geom, prm, 0)
    w_t = torch.from_numpy(w)
    y_spec, eps_ref = stage_chain(spec, w_t)

    att = st.FusedAttempt(geom, prm, 0)
    y2, cur = carry = att.pack(w_t)
    assert y2.shape == (2, 3) + SHAPE and y2.is_contiguous()
    assert cur.dtype == torch.int32 and int(cur) == 0
    carry_spec, eps = att.attempt(T, H, carry)
    assert torch.equal(eps, eps_ref)
    assert torch.equal(y2[1, :2], y_spec)        # the tail's slot 1 - cur
    assert torch.equal(y2[0], w_t)               # slot cur is untouched
    assert torch.equal(y2[1, 2], w_t[2])
    rejected = att.unpack(att.commit(carry_spec, False))
    assert int(cur) == 0 and torch.equal(rejected, w_t)
    accepted = att.unpack(att.commit(carry_spec, True))
    assert int(cur) == 1
    assert torch.equal(accepted[:2], y_spec)
    assert torch.equal(accepted[2], w_t[2])


def test_solve_matches_stage_path(case):
    """30 attempts of merson_solve with attempt_fn=FusedAttempt equal the
    stage_fn path (make_fused_stage with its stage-5 tail) exactly."""
    jprm, prm, jgeom, geom, w = case
    params = tm.MersonParams(delta=1e-3, h_min=1e-9, max_steps=30)
    y0 = torch.from_numpy(w.copy())
    st_a, _ = tm.merson_solve(None, tm.merson_init(y0, 0.0, 1e-4), 1e9,
                              params, attempt_fn=st.FusedAttempt(geom, prm, 0))
    st_b, _ = tm.merson_solve(None, tm.merson_init(y0, 0.0, 1e-4), 1e9,
                              params,
                              stage_fn=st.make_fused_stage(geom, prm, 0))
    assert torch.equal(y0, torch.from_numpy(w))
    assert st_a.steps_total == st_b.steps_total == 30
    assert st_a.steps == st_b.steps and 0 < st_a.steps
    assert st_a.t == st_b.t and st_a.h == st_b.h
    assert torch.equal(st_a.y, st_b.y)
