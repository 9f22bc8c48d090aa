"""The port's sharded classes against the JAX package's, on the CPU.

The JAX ``ShardedDeltaAttempt`` and ``make_sharded_fused_stage`` run in
Pallas interpret mode on two of the conftest's virtual CPU devices, at the
smallest shape their z-blocks allow; the port's run their plain versions
on a two-entry CPU mesh.  The 2-D and the compensated paths are held to
the JAX package's plain references ``XlaDeltaAttempt`` and
``XlaDeltaAttemptComp``, the oracles its own sharded tests close the loop
through; the interpret-mode 2-D comparison needs a 64 x 50 plane and is
marked slow.

Tolerances (those of tests/test_torch_delta.py): y_spec, dy and K to
1e-5 relative with an absolute floor of 1e-5 of the largest value, the
float32 sums being taken in other orders and with other multiply-add
contractions; eps to 1e-3 relative + 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.models.freezing.delta import (
    XlaDeltaAttempt, XlaDeltaAttemptComp)
from porousfreezethaw_tpu.models.freezing.parameters import (
    shift_temperature_origin as jshift)
from porousfreezethaw_tpu.ops.pallas.stencil import (
    pad_state, padded_k_shape, unpad_state)
from porousfreezethaw_tpu.parallel import fused as jfused
from porousfreezethaw_tpu.parallel.sharding import make_mesh as jmake_mesh
from porousfreezethaw_tpu_torch.convert import params_from_reference
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    shift_temperature_origin)
from porousfreezethaw_tpu_torch.parallel import (
    gather_freezing_state, make_mesh, shard_freezing_state)
from porousfreezethaw_tpu_torch.parallel.fused import (
    ShardedDeltaAttempt, ShardedDeltaAttempt2D, make_sharded_fused_stage)
from tests.test_freezing_equation import default_params

torch.set_num_threads(1)

CPU = torch.device("cpu")
T, H = 100.0, 0.05


def _case(shape, seed):
    """The JAX and the port's parameters and geometry, and a float32
    production state (u - u*, shifted parameters)."""
    jprm = default_params()
    prm = params_from_reference(jprm.as_dict())
    n3, n2, n1 = shape
    jgeom = JGeom(0.03, 0.03, 0.06, n1, n2, n3)
    geom = GridGeometry(0.03, 0.03, 0.06, n1, n2, n3)
    rng = np.random.default_rng(seed)
    w = np.stack([273.15 + 10 * (rng.random(shape) - 0.5),
                  rng.random(shape), 0.6 * rng.random(shape)])
    w = w.astype(np.float32)
    w[0] -= np.float32(jprm.u_star)
    return (jshift(jprm, jprm.u_star), shift_temperature_origin(
        prm, prm.u_star), jgeom, geom, w)


@pytest.fixture(scope="module")
def tiny():
    return _case((8, 8, 12), 5)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _close_eps(got, want):
    assert abs(got - want) <= 1e-3 * abs(want) + 1e-7, (got, want)


def _port(cls_or_fn, prm, geom, w, spec, **kw):
    mesh = make_mesh(spec, [CPU] * (4 if "," in spec else 2))
    att = cls_or_fn(geom, prm, 0, mesh, **kw)
    return att, mesh, att.pack(shard_freezing_state(torch.from_numpy(w),
                                                    mesh))


def test_sharded_delta_attempt_matches_jax(tiny):
    """One attempt of the JAX ShardedDeltaAttempt (interpret, z2, bz=2)
    against the port's at z2: y_spec and eps."""
    jprm, prm, jgeom, geom, w = tiny
    jmesh = jmake_mesh("z2", jax.devices()[:2])
    jatt = jfused.ShardedDeltaAttempt(jgeom, jprm, 0, jmesh, bz=2,
                                      interpret=True)
    wp = jax.device_put(pad_state(jnp.asarray(w), jgeom),
                        jfused.padded_sharding(jmesh))
    (_, spec_j), eps_j = jatt.attempt(T, H, jatt.pack(wp))
    att, mesh, y = _port(ShardedDeltaAttempt, prm, geom, w, "z2")
    (_, spec_p), eps_p = att.attempt(T, H, y)
    _close(gather_freezing_state(spec_p, mesh).numpy(),
           unpad_state(spec_j, jgeom))
    _close_eps(float(eps_p.max()), float(jnp.max(eps_j)))


def test_sharded_stage5_matches_jax(tiny):
    """One stage-5 call of the JAX make_sharded_fused_stage (interpret,
    z2, bz=2) against the port's at z2 (the overlap split on)."""
    jprm, prm, jgeom, geom, w = tiny
    rng = np.random.default_rng(6)
    ks = [rng.standard_normal((2,) + geom.shape).astype(np.float32)
          for _ in range(3)]
    jmesh = jmake_mesh("z2", jax.devices()[:2])
    put = lambda x: jax.device_put(x, jfused.padded_sharding(jmesh))
    jstage = jfused.make_sharded_fused_stage(jgeom, jprm, 0, jmesh, bz=2,
                                             interpret=True)
    kp = [put(pad_state(jnp.asarray(k), jgeom)) for k in ks]
    assert kp[0].shape == padded_k_shape(jgeom)
    y_j, eps_j = jstage.stage5(T, H, put(pad_state(jnp.asarray(w), jgeom)),
                               list(zip([0.5, -1.5, 2.0], kp)))
    mesh = make_mesh("z2", [CPU, CPU])
    stage = make_sharded_fused_stage(geom, prm, 0, mesh)
    assert stage.split
    y_p, eps_p = stage.stage5(
        T, H, shard_freezing_state(torch.from_numpy(w), mesh),
        [(c, shard_freezing_state(torch.from_numpy(k), mesh))
         for c, k in zip([0.5, -1.5, 2.0], ks)])
    _close(gather_freezing_state(y_p, mesh).numpy(), unpad_state(y_j, jgeom))
    _close_eps(float(eps_p.max()), float(jnp.max(eps_j)))


def test_2d_attempt_matches_xla(tiny):
    """The port's ShardedDeltaAttempt2D at z2,y2 against the JAX
    XlaDeltaAttempt on the whole state: y_spec, eps and the commit."""
    jprm, prm, jgeom, geom, w = tiny
    jatt = XlaDeltaAttempt(jgeom, jprm, 0)
    (_, spec_j), eps_j = jatt.attempt(T, H, jnp.asarray(w))
    att, mesh, y = _port(lambda g, p, m, mesh: ShardedDeltaAttempt2D(
        g, p, m, mesh), prm, geom, w, "z2,y2")
    (_, spec_p), eps_p = att.attempt(T, H, y)
    _close(gather_freezing_state(spec_p, mesh).numpy(), spec_j)
    _close_eps(float(eps_p.max()), float(jnp.max(eps_j)))
    committed = att.commit((y, spec_p), True)
    _close(gather_freezing_state(committed, mesh).numpy(),
           jatt.commit((jnp.asarray(w), spec_j), jnp.asarray(True)))


def test_compensated_attempt_matches_xla(tiny):
    """The port's compensated ShardedDeltaAttempt at z2 against the JAX
    XlaDeltaAttemptComp: dy, eps and the 5-plane TwoSum commit."""
    jprm, prm, jgeom, geom, w = tiny
    jatt = XlaDeltaAttemptComp(jgeom, jprm, 0)
    y5 = jatt.pack(jnp.asarray(w))
    (_, dy_j), eps_j = jatt.attempt(T, H, y5)
    att, mesh, y = _port(ShardedDeltaAttempt, prm, geom, w, "z2",
                         compensated=True)
    (_, dy_p), eps_p = att.attempt(T, H, y)
    _close(gather_freezing_state(dy_p, mesh).numpy(), dy_j)
    _close_eps(float(eps_p.max()), float(jnp.max(eps_j)))
    committed = gather_freezing_state(att.commit((y, dy_p), True), mesh)
    want = np.asarray(jatt.commit((y5, dy_j), jnp.asarray(True)))
    assert committed.shape == want.shape == (5,) + geom.shape
    _close(committed[:3].numpy(), want[:3])
    # the lo planes hold rounding errors of the hi planes: to 1e-5 of the
    # largest hi value
    np.testing.assert_allclose(committed[3:].numpy(), want[3:], rtol=0,
                               atol=1e-5 * np.abs(want[:2]).max())


@pytest.mark.slow
def test_2d_attempt_matches_jax_interpret():
    """The JAX ShardedDeltaAttempt2D (interpret, z2,y2) needs a 64 x 50
    plane (8 lane rows per y-shard): one attempt against the port's."""
    jprm, prm, jgeom, geom, w = _case((8, 50, 64), 7)
    jmesh = jmake_mesh("z2,y2", jax.devices()[:4])
    jatt = jfused.ShardedDeltaAttempt2D(jgeom, jprm, 0, jmesh, bz=2,
                                        interpret=True)
    wp = jax.device_put(jfused.pad_state_2d(jnp.asarray(w), jgeom, 2),
                        jfused.padded_sharding_2d(jmesh))
    (_, spec_j), eps_j = jatt.attempt(T, H, jatt.pack(wp))
    att, mesh, y = _port(lambda g, p, m, mesh: ShardedDeltaAttempt2D(
        g, p, m, mesh), prm, geom, w, "z2,y2")
    (_, spec_p), eps_p = att.attempt(T, H, y)
    _close(gather_freezing_state(spec_p, mesh).numpy(),
           jfused.unpad_state_2d(spec_j, jgeom))
    _close_eps(float(eps_p.max()), float(jnp.max(eps_j)))
