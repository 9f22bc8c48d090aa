"""The port's right-hand side (models/freezing/equation.py, PyTorch)
against the JAX package's ``make_rhs`` on the same seeded states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.models.freezing import make_rhs as jax_make_rhs
from porousfreezethaw_tpu_torch.convert import params_from_reference
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing import make_rhs
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
    rng = np.random.default_rng(11)
    w = np.stack([273.15 + 10 * (rng.random(SHAPE) - 0.5),
                  rng.random(SHAPE), 0.6 * rng.random(SHAPE)])
    return jprm, prm, jgeom, geom, w


# t on each side of the phase switch: the Dirichlet top changes value
T_VALUES = [100.0, 5 * 3600.0 + 1.0]


@pytest.mark.parametrize("mode", MODES)
def test_rhs_f64_matches_jax(case, mode):
    """f64: 1e-12 relative with a 1e-3 scale floor."""
    jprm, prm, jgeom, geom, w = case
    jrhs = jax_make_rhs(jgeom, jprm, calc_mode=mode)
    rhs = make_rhs(geom, prm, mode, "cpu")
    for t in T_VALUES:
        want = np.asarray(jrhs(t, jnp.asarray(w, jnp.float64)))
        got = rhs(t, torch.from_numpy(w)).numpy()
        scale = np.maximum(np.abs(want), 1e-3)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_rhs_f32_matches_jax(case, mode):
    """f32: 1e-5 relative to each field's largest value (the two
    frameworks may contract and order the float32 operations differently)."""
    jprm, prm, jgeom, geom, w = case
    w32 = w.astype(np.float32)
    jrhs = jax_make_rhs(jgeom, jprm, calc_mode=mode)
    rhs = make_rhs(geom, prm, mode, "cpu")
    for t in T_VALUES:
        want = np.asarray(jrhs(t, jnp.asarray(w32))).astype(np.float64)
        got = rhs(t, torch.from_numpy(w32))
        assert got.dtype == torch.float32
        got = got.numpy().astype(np.float64)
        for v in range(3):
            scale = max(np.abs(want[v]).max(), 1e-30)
            np.testing.assert_allclose(got[v], want[v], rtol=1e-5,
                                       atol=1e-5 * scale)


def test_dirichlet_switch_changes_top_plane(case):
    """Across phase_switch_time only the top plane's temperature flux
    changes, and it changes by the Dirichlet jump (f64, vs JAX)."""
    jprm, prm, jgeom, geom, w = case
    jrhs = jax_make_rhs(jgeom, jprm, calc_mode=0)
    rhs = make_rhs(geom, prm, 0, "cpu")
    w64 = torch.from_numpy(w)
    before = rhs(T_VALUES[0], w64).numpy()
    after = rhs(T_VALUES[1], w64).numpy()
    diff = after - before
    assert np.abs(diff[0, -1]).min() > 0
    assert np.all(diff[0, :-1] == 0) and np.all(diff[1:] == 0)
    jdiff = (np.asarray(jrhs(T_VALUES[1], jnp.asarray(w)))
             - np.asarray(jrhs(T_VALUES[0], jnp.asarray(w))))
    np.testing.assert_allclose(diff, jdiff, rtol=1e-9,
                               atol=1e-9 * np.abs(jdiff).max())
