"""The float64 stage kernel's plain version and the f64 path's route to it
(``ops/cuda/stencil.py`` ``fused_stage_plain`` on a float64
``StencilSpec``, ``StageAttempt(..., dtype=torch.float64)``;
``models/freezing/attempt.py`` ``stage_route``), on the CPU:

* each of the five stages of the plain version, and its stage-5 tail,
  equals ``merson_stages``' stage over ``make_rhs`` (and ``RHSAttempt``'s
  tail) within 1e-13 of max|ref|, in calc modes 0/1/2/10/11, across the
  Dirichlet switch;
* the float64 spec keeps the host's float64 constants, the float32 spec
  rounds each once;
* the route rule takes the stage kernel only for a float64 state of the
  single-device ``make_rhs`` without noise on its own spacing, on a loop
  that runs kernels;
* the route's attempts on the device loop with the plain versions give
  the host loop's counts and state (``merson_solve`` over ``make_rhs``).

The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config import parse_param_file
from porousfreezethaw_tpu_torch.core import tracing
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing import physics
from porousfreezethaw_tpu_torch.models.freezing.attempt import (
    PLAIN_RHS, PlainAttempt, stage_route)
from porousfreezethaw_tpu_torch.models.freezing.equation import (
    make_noise_field, make_rhs)
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    FreezingParams)
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from porousfreezethaw_tpu_torch.parallel.halo import make_halo_rhs
from porousfreezethaw_tpu_torch.parallel.sharding import make_mesh
from porousfreezethaw_tpu_torch.solvers import merson as tm

torch.set_num_threads(1)

SHAPE = (16, 8, 8)       # (n3, n2, n1)
MODES = (0, 1, 2, 10, 11)
H = 0.05


def _params():
    pf = parse_param_file(freezing_params_text(100, 0),
                          env={"OUTPUT": "unused"})
    return FreezingParams.from_dict(pf.vars)


def _geom():
    return GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])


def _state(prm, seed=5):
    """(3, n3, n2, n1) float64: u about u_star, p in [0, 1], gl in
    [0, 0.6]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([
        prm.u_star + 6.0 * (rng.random(SHAPE) - 0.5), rng.random(SHAPE),
        0.6 * rng.random(SHAPE)]))


def _stages(rhs, y, t, h):
    """merson_stages' five stages from y at (t, h): the K of each (u, p)
    and the ts64 and hs the control block holds for them."""
    ks = []

    def rec(ts, w):
        k = rhs(ts, w)
        ks.append(k[:st.K_VARS])
        return k

    hs = (h / 3, h / 6, h / 8, h)
    ts = (t, t + h / 3, t + h / 2, t + h)
    tm.merson_stages(rec, y, hs, ts)
    return ks, ts, hs


# the K inputs of stages 1-5 (indices into the stages' K)
INPUTS = ((), (0,), (0, 1), (0, 2), (0, 2, 3))


@pytest.mark.parametrize("stage", range(5))
@pytest.mark.parametrize("mode", MODES)
def test_plain_stage_equals_merson_stage(mode, stage):
    """Stage ``stage`` of the float64 plain version on merson_stages'
    inputs (the c_a of STAGE_COEFS, the block's stage time and scale)
    equals merson_stages' K within 1e-13 of max|K|; stage 5's tail equals
    RHSAttempt's update and eps.  The step crosses the Dirichlet switch
    between stages 3 and 4."""
    prm = _params()
    geom = _geom()
    y = _state(prm)
    t = prm.phase_switch_time - 0.4 * H
    ks, ts, hs = _stages(make_rhs(geom, prm, mode, "cpu"), y, t, H)
    spec = st.StencilSpec.of(geom, prm, mode, torch.float64)
    coefs = st.STAGE_COEFS[torch.float64][stage]
    kk = [(c, ks[i]) for c, i in zip(coefs, INPUTS[stage])]
    args = (spec, ts[st.STAGE64_TIME[stage]], hs[st.STAGE64_SCALE[stage]],
            y, kk)
    got = st.fused_stage_plain(*args)
    ref = ks[stage]
    assert got.dtype == torch.float64
    tol = 1e-13 * float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0.0, atol=tol)
    if stage == 4:
        y_spec, eps = st.fused_stage_plain(*args, stage5=True)
        k1, k3, k4, k5 = ks[0], ks[2], ks[3], ks[4]
        want = y[:2] + (0.5 * (k1 + k5) + 2.0 * k4) * hs[0]
        err = torch.amax(torch.abs(0.2 * k1 - 0.9 * k3 + 0.8 * k4
                                   - 0.1 * k5))
        torch.testing.assert_close(y_spec, want, rtol=0.0,
                                   atol=1e-13 * float(want.abs().max()))
        assert abs(float(eps[0]) - float(err)) <= 1e-13 * float(err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spec_constants_in_the_field_width(dtype):
    """The float64 spec holds the host's float64 constants unrounded (the
    GridGeometry spacing, the parameters and physics.Coeffs as make_rhs
    forms them); the float32 spec each rounded once."""
    prm = _params()
    geom = _geom()
    c = physics.Coeffs.of(prm)
    i1, i2, i3 = geom.inv_h
    want = dict(
        h1_2=i1**2, h2_2=i2**2, h3_2=i3**2, h1d2=0.5 * i1, h2d2=0.5 * i2,
        h3d2=0.5 * i3, u_star=prm.u_star, L=prm.L, alpha=prm.alpha,
        zeta=prm.zeta, glass_rho=prm.glass_rho, ice_rho=prm.ice_rho,
        water_rho=prm.water_rho, glass_cp=prm.glass_cp, ice_cp=prm.ice_cp,
        water_cp=prm.water_cp, glass_lambda=prm.glass_lambda,
        ice_lambda=prm.ice_lambda, water_lambda=prm.water_lambda,
        lam_p_slope=prm.ice_lambda - prm.water_lambda,
        rho_p_slope=prm.ice_rho - prm.water_rho,
        cp_p_slope=prm.ice_cp - prm.water_cp, A=c.xi_2_inv_a,
        B=prm.b * prm.alpha * prm.mu,
        C=c.xi_inv_b_sqrt_a2 * prm.alpha * prm.mu, p_eps0=prm.p_eps0,
        p_eps1=prm.p_eps1, eps2_3=c.eps2_3, eps3_2=c.eps3_2,
        gamma=prm.gamma, neg_half_gamma=-0.5 * prm.gamma,
        eps_reg=physics.EPS_REGULARIZATION, top_temp1=prm.top_temp1,
        top_temp2=prm.top_temp2, phase_switch_time=prm.phase_switch_time)
    assert set(want) == set(st.CONST_NAMES)
    spec = st.StencilSpec.of(geom, prm, 0, dtype)
    assert spec.dtype == dtype
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    assert spec.packed.dtype == np_dtype
    expect = np.array([want[n] for n in st.CONST_NAMES]).astype(np_dtype)
    assert np.array_equal(spec.packed, expect)
    # the float64 constants are not the float32 ones
    rounded = expect.astype(np.float32).astype(np.float64)
    assert (dtype == torch.float64) == bool(
        np.any(spec.packed.astype(np.float64) != rounded))


def _route_case(name):
    """(rhs, shape, dtype, mesh, kernel, route expected) of a case."""
    prm = _params()
    geom = _geom()
    rhs = make_rhs(geom, prm, 0, "cpu")
    if name == "f64_kernel_loop":
        return rhs, SHAPE, torch.float64, None, True, True
    if name == "f64_cpu_loop":
        return rhs, SHAPE, torch.float64, None, False, False
    if name == "f32_kernel_loop":
        return rhs, SHAPE, torch.float32, None, True, False
    if name == "f32_noise":
        noisy = dataclasses.replace(prm, u_noise_amp=0.5)
        noise = make_noise_field(geom, noisy, seed=3, dtype=np.float32)
        return (make_rhs(geom, prm, 0, "cpu", noise=noise), SHAPE,
                torch.float32, None, True, False)
    if name == "f64_noise":
        noisy = dataclasses.replace(prm, u_noise_amp=0.5)
        noise = make_noise_field(geom, noisy, seed=3)
        return (make_rhs(geom, prm, 0, "cpu", noise=noise), SHAPE,
                torch.float64, None, True, False)
    if name == "mesh_halo":
        mesh = make_mesh("z2", device="cpu")
        return (make_halo_rhs(geom, prm, 0, mesh), SHAPE, torch.float64,
                mesh, True, False)
    if name == "mesh":
        return rhs, SHAPE, torch.float64, make_mesh("z2", device="cpu"), \
            True, False
    if name == "inv_h_override":
        inv_h = tuple(2.0 * v for v in geom.inv_h)
        return (make_rhs(geom, prm, 0, "cpu", inv_h=inv_h), SHAPE,
                torch.float64, None, True, False)
    if name == "inv_h_own":
        return (make_rhs(geom, prm, 0, "cpu", inv_h=geom.inv_h), SHAPE,
                torch.float64, None, True, True)
    if name == "other_shape":
        return rhs, (8, 8, 8), torch.float64, None, True, False
    if name == "not_make_rhs":
        return ((lambda t, w: rhs(t, w)), SHAPE, torch.float64, None, True,
                False)
    raise KeyError(name)


ROUTE_CASES = ("f64_kernel_loop", "f64_cpu_loop", "f32_kernel_loop",
               "f32_noise", "f64_noise", "mesh_halo", "mesh",
               "inv_h_override", "inv_h_own", "other_shape", "not_make_rhs")


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_stage_route_rule(name):
    """stage_route takes the float64 stage kernel only for a float64 state
    of the single-device make_rhs without noise on its own spacing, on a
    kernel loop; the f32 paths, noise, a mesh, a CPU loop, a spacing
    override and any other right-hand side keep the plain one."""
    rhs, shape, dtype, mesh, kernel, want = _route_case(name)
    assert stage_route(rhs, shape, dtype, mesh, kernel) is want


def test_plain_attempt_on_the_cpu_keeps_the_plain_rhs():
    """A PlainAttempt of a CPU right-hand side (its loop runs the plain
    versions) takes the plain route, its set-up span says so, and its
    device loop is its own."""
    prm = _params()
    tracing.clear()
    att = PlainAttempt(make_rhs(_geom(), prm, 0, "cpu"), SHAPE,
                       torch.float64)
    assert att.route == PLAIN_RHS
    sp = [s for s in tracing.spans() if s.name == "pft.setup.attempt"
          and s.attrs.get("cls") == "PlainAttempt"]
    assert sp and sp[-1].attrs["route"] == PLAIN_RHS
    assert att.device_loop(torch.device("cpu")).attempt is att


@pytest.mark.parametrize("mode", MODES)
def test_stage_route_attempts_equal_host_loop(mode):
    """The float64 StageAttempt (the stage-kernel route's attempts) on the
    device loop with its plain versions, in chunks of 12 attempts with a
    trace from 2 ms below the Dirichlet switch across it (its jump is
    rejected down to h_min, 1e-4, whose forced accepts cross it), against
    merson_solve over make_rhs: equal counts, statuses and traces, t and
    h, and the state within 1e-12 of max|ref| (the plain versions round
    as merson_stages does, so they agree bit for bit)."""
    prm = _params()
    geom = _geom()
    rhs = make_rhs(geom, prm, mode, "cpu")
    att = st.StageAttempt(geom, prm, mode, dtype=torch.float64)
    y0 = _state(prm, seed=1)
    t0 = prm.phase_switch_time - 2e-3
    params = tm.MersonParams(delta=1e-3, h_min=1e-4, max_steps=12,
                             record_trace=12)
    sa = sb = tm.merson_init(y0, t0, 1e-6)
    for _ in range(3):
        a = tm.merson_solve(rhs, sa, t0 + 100.0, params)
        b = tm.merson_solve_device(sb, t0 + 100.0, params, att)
        assert a[1] == b[1]
        assert (a[0].steps, a[0].steps_total) == (b[0].steps,
                                                  b[0].steps_total)
        assert (a[0].t, a[0].h) == (b[0].t, b[0].h)
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
        ref = a[0].y
        assert float((b[0].y - ref).abs().max()) <= 1e-12 * float(
            ref.abs().max())
        sa, sb = a[0], b[0]
    assert sb.steps >= 10 and sb.t > prm.phase_switch_time
