"""Every mesh path of both apps on the device-resident Merson loop
(``merson_solve_device``), on virtual shards of the CPU
(``make_mesh(spec, [cpu] * n)``), where the kernel wrappers and the
control and commit kernels compute with their plain versions.

* The freezing kernel paths (parallel/fused.py): the z2 delta attempt,
  its compensated commit, the z2,y3 attempt (uneven y windows of 3, 3
  and 2 rows) and the classic z2 stage path (the overlap split: 4 planes
  a shard), on tests/test_torch_sharded.py's tiny grid (8, 8, 12).
* The plain right-hand side with halo copies (parallel/halo.py,
  ``PlainAttempt`` on the list of shards): f64 at z2,y2 and at z3 (uneven
  z windows of 3, 3 and 2 planes), f32 with a noise field at z2.
* The DEM's sharded dense term (``DEMAttempt`` on the shards' dicts) at
  p2 and p3.

Each case from just below the Dirichlet top's switch (the freezing
paths) to an end time whose last step is trimmed: the device loop in one
call, and in chunks of 5 attempts through ``between``, equals the host
loop (``merson_solve``) on the same mesh in one call bit for bit (state,
t, h, counts, status, trace), and so does the single-device device loop
(the state gathered).  Then one short solve per freezing kernel path
against the JAX package's on the CPU: the XLA oracles ``XlaDeltaAttempt``
and ``XlaDeltaAttemptComp`` on one device for the delta paths (the
sharded JAX attempts in interpret mode take some 30 s an attempt), the
Pallas stage in interpret mode on one device for the classic path; equal
counts, the state after the first accepted step within 1e-5 of max|ref|
(tests/test_torch_sharded.py's ``_close``: float32 sums in other orders
and contractions; see ``test_kernel_path_matches_jax``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.models.freezing.delta import (
    XlaDeltaAttempt, XlaDeltaAttemptComp)
from porousfreezethaw_tpu.ops.pallas import stencil as jst
from porousfreezethaw_tpu.solvers import merson as jm
from porousfreezethaw_tpu_torch.models.dem import (
    DEMAttempt, DEMConfig, icond_dense, make_dem_rhs)
from porousfreezethaw_tpu_torch.models.freezing.attempt import PlainAttempt
from porousfreezethaw_tpu_torch.models.freezing.equation import (
    make_noise_field, make_rhs)
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from porousfreezethaw_tpu_torch.parallel import (
    gather_dem_state, gather_freezing_state, make_mesh, shard_dem_state,
    shard_freezing_state)
from porousfreezethaw_tpu_torch.parallel.fused import (
    ShardedDeltaAttempt, ShardedDeltaAttempt2D, ShardedStageAttempt,
    make_sharded_fused_stage)
from porousfreezethaw_tpu_torch.parallel.halo import make_halo_rhs
from porousfreezethaw_tpu_torch.solvers import merson as tm
from tests.test_torch_sharded import _case, _close

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPE = (8, 8, 12)       # (n3, n2, n1)
CHUNK = 5                # attempts of one chunk through ``between``


def _mesh(spec):
    n = int(np.prod([int(p.strip()[1:] or 1) for p in spec.split(",")]))
    return make_mesh(spec, [CPU] * n)


def _same(a, b, mesh=None, gather=None):
    """Whether two solve results agree bit for bit: status, t, h, counts,
    trace and the state (``b``'s gathered over ``mesh`` when ``a``'s is
    one device's)."""
    (sa, status_a, tr_a), (sb, status_b, tr_b) = a, b
    if (status_a, sa.t, sa.h, sa.steps, sa.steps_total) != (
            status_b, sb.t, sb.h, sb.steps, sb.steps_total):
        return False
    if not all(torch.equal(x, y) for x, y in zip(tr_a, tr_b)):
        return False
    ya, yb = sa.y, sb.y if gather is None else gather(sb.y)
    if isinstance(ya, dict):
        return all(torch.equal(ya[k], yb[k]) for k in ya)
    if isinstance(ya, list):
        if isinstance(ya[0], dict):
            return all(torch.equal(x[k], y[k]) for x, y in zip(ya, yb)
                       for k in x)
        return all(torch.equal(x, y) for x, y in zip(ya, yb))
    return torch.equal(ya, yb)


def _chunked(att, state, tf, params):
    """The device loop through ``between`` in chunks of CHUNK attempts:
    the result with the trace the chunks drained."""
    trace = []

    def between(tt, hh, n, steps):
        assert steps == len(trace)
        trace.extend(zip(tt[:n].tolist(), hh[:n].tolist()))
        return False

    p = dataclasses.replace(params, max_steps=CHUNK, record_trace=CHUNK)
    st_, status, _ = tm.merson_solve_device(state, tf, p, att,
                                            between=between)
    n = params.record_trace
    t_tr, h_tr = (torch.zeros(n, dtype=torch.float64) for _ in range(2))
    for i, (t, h) in enumerate(trace[:n]):
        t_tr[i], h_tr[i] = t, h
    return st_, status, (t_tr, h_tr)


def _check_loops(host, make_att, single_att, y_mesh, y_one, t0, h0, tf,
                 params, gather):
    """The host loop, the device loop in one call and in chunks, and the
    single-device device loop, all bit for bit; returns the host loop's
    result."""
    ref = host(tm.merson_init(y_mesh, t0, h0), tf, params)
    assert ref[1] == tm.OK and ref[0].steps_total > 2 * CHUNK
    assert ref[0].steps <= params.record_trace      # the whole trace
    one = tm.merson_solve_device(tm.merson_init(y_mesh, t0, h0), tf, params,
                                 make_att())
    chunks = _chunked(make_att(), tm.merson_init(y_mesh, t0, h0), tf,
                      params)
    single = tm.merson_solve_device(tm.merson_init(y_one, t0, h0), tf,
                                    params, single_att)
    assert _same(ref, one)
    assert _same(ref, chunks)
    assert _same(single, one, gather=gather)
    return ref


# --------------------------------------------------------------------------
# the freezing kernel paths
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return _case(SHAPE, 5)


KERNEL_PATHS = {
    # name: (mesh spec, sharded attempt, single-device attempt, growth)
    "delta_z2": ("z2", ShardedDeltaAttempt, st.DeltaAttempt, 0.0),
    "compensated_z2": ("z2", lambda *a: ShardedDeltaAttempt(
        *a, compensated=True), st.DeltaAttemptComp, 0.0),
    "delta_z2,y3": ("z2,y3", ShardedDeltaAttempt2D, st.DeltaAttempt, 0.0),
    # the classic stage path with the app's f32 noise-floor escape
    "stage_z2": ("z2", ShardedStageAttempt, st.StageAttempt, 1.05),
}


@pytest.mark.parametrize("name", KERNEL_PATHS)
def test_kernel_path_device_loop(tiny, name):
    """From 2e-3 s below the Dirichlet top's switch (D1 and dDi, and the
    classic stage's top, change within the attempts that reach past it;
    the jump is rejected down to h_min = 1e-5, whose forced accepts cross
    it) to 4e-3 s later, the last step trimmed: 25-29 attempts."""
    _, prm, _, geom, w = tiny
    spec, sharded, single, growth = KERNEL_PATHS[name]
    mesh = _mesh(spec)
    if name.startswith("stage"):
        stage_fn = make_sharded_fused_stage(geom, prm, 0, mesh)

        def host(s, tf, p):
            return tm.merson_solve(None, s, tf, p, stage_fn=stage_fn)
    else:
        host_att = sharded(geom, prm, 0, mesh)

        def host(s, tf, p):
            return tm.merson_solve(None, s, tf, p, attempt_fn=host_att)
    params = tm.MersonParams(delta=1e-3, h_min=1e-5, handle_nan=True,
                             accept_growth_min=growth, record_trace=64)
    y = torch.from_numpy(w)
    t0 = prm.phase_switch_time - 2e-3
    ref = _check_loops(host, lambda: sharded(geom, prm, 0, mesh),
                       single(geom, prm, 0), shard_freezing_state(y, mesh),
                       y, t0, 1e-4, t0 + 4e-3, params,
                       lambda ys: gather_freezing_state(ys, mesh))
    assert ref[0].t > prm.phase_switch_time
    assert ref[0].steps_total > ref[0].steps


def _jax_solver(name, jprm, jgeom, params):
    """The JAX package's solve call of a kernel path on one device (jitted
    once), its state from the numpy state, and the fields it returns as
    the port's (3, n3, n2, n1)."""
    if name.startswith("stage"):
        stage = jst.make_fused_stage(jgeom, jprm, 0, bz=2, interpret=True)
        return (jax.jit(lambda s: jm.merson_solve(None, s, 1e9, params,
                                                  stage_fn=stage)),
                lambda w: jst.pad_state(jnp.asarray(w), jgeom),
                lambda y: np.asarray(jst.unpad_state(y, jgeom)))
    att = (XlaDeltaAttemptComp if name.startswith("comp")
           else XlaDeltaAttempt)(jgeom, jprm, 0)
    return (jax.jit(lambda s: jm.merson_solve(None, s, 1e9, params,
                                              attempt_fn=att)),
            jnp.asarray, lambda y: np.asarray(y)[:3])


@pytest.mark.parametrize("name", KERNEL_PATHS)
def test_kernel_path_matches_jax(tiny, name):
    """A solve from t = 0, h = 0.3 through the port's device loop on the
    mesh and through the JAX package's on one device, in two calls: the
    first of 2 attempts (a rejection, then an accepted step), after which
    the states agree within 1e-5 of max|ref|; the second of 10 more,
    after which the counts are equal and t agrees to 1e-3.  Beyond the
    first step the states are not compared: eps is the max of a
    difference of nearly equal stage values, which the two frameworks'
    float32 roundings part by about 4e-4 relative (the single-device
    port's DeltaAttempt against XlaDeltaAttempt at h = 0.1), so each
    solver's next h, and its state with it, parts from the other's by
    about 1e-4 relative while the counts stay equal."""
    jprm, prm, jgeom, geom, w = tiny
    spec, sharded, _, growth = KERNEL_PATHS[name]
    mesh = _mesh(spec)
    att = sharded(geom, prm, 0, mesh)
    kw = dict(delta=1e-3, h_min=1e-9, max_steps=2, handle_nan=True,
              accept_growth_min=growth)
    jsolve, jstate, jfields = _jax_solver(name, jprm, jgeom,
                                          jm.MersonParams(**kw))
    sj = jm.merson_init(jstate(w), 0.0, 0.3)
    sp = tm.merson_init(shard_freezing_state(torch.from_numpy(w), mesh), 0.0,
                        0.3)
    for chunk in range(6):
        sj, status_j = jsolve(sj)
        sp, status = tm.merson_solve_device(sp, 1e9, tm.MersonParams(**kw),
                                            att)
        assert status == int(status_j) == tm.MAX_STEPS
        assert (sp.steps, sp.steps_total) == (int(sj.steps),
                                              int(sj.steps_total))
        if chunk == 0:
            assert sp.steps == 1
            _close(gather_freezing_state(sp.y, mesh)[:3].numpy(),
                   jfields(sj.y))
    assert sp.t == pytest.approx(float(sj.t), rel=1e-3)


# --------------------------------------------------------------------------
# the plain right-hand side with halo copies
# --------------------------------------------------------------------------

HALO_CASES = {
    # name: (mesh spec, dtype, noise)
    "f64_z2,y2": ("z2,y2", torch.float64, False),
    "f64_z3": ("z3", torch.float64, False),
    "noise_f32_z2": ("z2", torch.float32, True),
}


@pytest.mark.parametrize("name", HALO_CASES)
def test_halo_path_device_loop(tiny, name):
    """From 1e-3 s below the Dirichlet top's switch, through the switch
    (rejected down to the shipped tau_min, whose forced accepts cross
    it), to 1e-3 s after it, the last step trimmed (31 attempts in f64,
    22 in f32); f64 in calc mode 0, f32 with a noise field as the app
    runs it (NaN backoff on, growth floor 1.05)."""
    _, prm, _, geom, w = tiny
    spec, dtype, noisy = HALO_CASES[name]
    mesh = _mesh(spec)
    kw = {}
    noise = None
    y = torch.from_numpy(w).to(dtype)
    if noisy:
        noise = make_noise_field(geom, dataclasses.replace(
            prm, u_noise_amp=0.5), seed=3, dtype=np.float32)
        kw = dict(handle_nan=True, accept_growth_min=1.05)
    rhs = make_halo_rhs(geom, prm, 0, mesh, noise=noise)

    def host(s, tf, p):
        return tm.merson_solve(rhs, s, tf, p)

    params = tm.MersonParams(delta=1e-3, h_min=1e-6, record_trace=64, **kw)
    t0 = prm.phase_switch_time - 1e-3
    single = PlainAttempt(make_rhs(geom, prm, 0, "cpu", noise=noise),
                          geom.shape, dtype)
    ref = _check_loops(host,
                       lambda: PlainAttempt(rhs, geom.shape, dtype, mesh=mesh),
                       single, shard_freezing_state(y, mesh), y, t0, 1e-6,
                       t0 + 2e-3, params,
                       lambda ys: gather_freezing_state(ys, mesh))
    assert ref[0].t > prm.phase_switch_time


def test_plain_attempt_refuses_foreign_shards(tiny):
    """A mesh PlainAttempt refuses a single state, shards of another mesh
    and a mesh whose shards lie on several devices."""
    _, prm, _, geom, w = tiny
    mesh = _mesh("z2")
    att = PlainAttempt(make_halo_rhs(geom, prm, 0, mesh), geom.shape,
                       torch.float32, mesh=mesh)
    params = tm.MersonParams(delta=1e-3, max_steps=2)
    y = torch.from_numpy(w)
    for bad in (y, shard_freezing_state(y, _mesh("z4"))):
        with pytest.raises(ValueError, match="PlainAttempt expects shards"):
            tm.merson_solve_device(tm.merson_init(bad, 0.0, 1e-6), 1.0,
                                   params, att)
    two = make_mesh("z2", [CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="share one device"):
        PlainAttempt(None, geom.shape, torch.float32, mesh=two)._dev_alloc(
            CPU, False)


# --------------------------------------------------------------------------
# the DEM's sharded dense term
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["p2", "p3"])
def test_dem_mesh_device_loop(spec):
    """tests/test_torch_dem_device.py's bed of 12 spheres (seed 5) given
    random velocities and spins and a pair in contact, f64, friction and
    spin, to t = 0.01 (27 attempts, 5 of them rejected)."""
    cfg = DEMConfig(variant="friction_angular", n=12, r=0.1)
    y, _ = icond_dense(cfg, seed=5)
    rng = np.random.RandomState(6)
    y["vel"] = rng.standard_normal((12, 3))
    y["angvel"] = 5.0 * rng.standard_normal((12, 3))
    y["pos"][1] = y["pos"][0] + [2 * cfg.r * 0.9, 0, 0]
    y = {k: torch.tensor(v) for k, v in y.items()}
    mesh = make_mesh(spec, device="cpu")
    rhs = make_dem_rhs(cfg, mesh=mesh, device="cpu")

    def host(s, tf, p):
        return tm.merson_solve(rhs, s, tf, p)

    params = tm.MersonParams(delta=cfg.delta, h_min=cfg.ht_min,
                             record_trace=64)
    ref = _check_loops(host, lambda: DEMAttempt(rhs),
                       DEMAttempt(make_dem_rhs(cfg, device="cpu")),
                       shard_dem_state(y, mesh), y, 0.0, cfg.ht, 0.01,
                       params, gather_dem_state)
    assert ref[0].steps_total > ref[0].steps
