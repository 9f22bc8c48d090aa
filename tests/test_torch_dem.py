"""The port's DEM (models/dem, PyTorch) and its solvers on dict states,
against the JAX package on the same seeded inputs, on the CPU.

* The right-hand side of the four variants against JAX ``make_dem_rhs``
  (f64: 1e-12 of max|ref| per leaf; f32: 1e-5 of max|ref| per leaf, the
  two frameworks rounding float32 sums in other orders) and against the
  NumPy pair loop of tests/test_dem.py (rtol 1e-10, atol 1e-12, as there).
* The closed-form two-sphere cases and the initial conditions of
  tests/test_dem.py, on the port (the iconds equal JAX's exactly).
* The Merson controller on the dict state: the same successful and
  attempted step counts as JAX's over a fixed window, and NaN propagation
  through the per-leaf eps max.
* rk4 and dopri45 against JAX's (tests/test_merson.py, tests/test_analysis.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.models import dem as jdem
from porousfreezethaw_tpu.solvers import (
    MersonParams as JParams, dopri45_solve as jdopri, merson_init as jinit,
    merson_solve as jsolve, rk4_solve as jrk4)
from porousfreezethaw_tpu_torch.convert import dem_state_from_reference
from porousfreezethaw_tpu_torch.core.device import DeviceError
from porousfreezethaw_tpu_torch.models.dem import (
    DEMConfig, icond_2spheres, icond_dense, icond_sparse, make_dem_rhs)
from porousfreezethaw_tpu_torch.solvers import (
    MersonParams, dopri45_solve, merson_init, merson_solve, rk4_solve)
from tests.test_dem import numpy_dem_rhs

torch.set_num_threads(1)

VARIANTS = ["basic", "basic_WB", "friction", "friction_angular"]


def to_torch(y, dtype=torch.float64):
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype) for k, v in
            y.items()}


def to_jax(y, dtype=jnp.float64):
    return {k: jnp.asarray(v, dtype) for k, v in y.items()}


def moving_state(cfg):
    """tests/test_dem.py's state: the dense icond with random velocities
    and spins, and two spheres pushed into contact."""
    state, _ = icond_dense(cfg, seed=3)
    rng = np.random.RandomState(4)
    state["vel"] = rng.standard_normal((cfg.n, 3))
    if cfg.angular:
        state["angvel"] = 5.0 * rng.standard_normal((cfg.n, 3))
    state["pos"][1] = state["pos"][0] + [2 * cfg.r * 0.9, 0, 0]
    return state


@pytest.mark.parametrize("variant", VARIANTS)
def test_rhs_f64_matches_jax_and_numpy_loop(variant):
    cfg = DEMConfig(variant=variant, n=12)
    state = moving_state(cfg)
    want = jdem.make_dem_rhs(jdem.DEMConfig(variant=variant, n=12))(
        0.0, to_jax(state))
    rhs = make_dem_rhs(cfg, device="cpu")
    assert rhs.neighbor_struct is None
    got = rhs(0.0, to_torch(state))
    loop = numpy_dem_rhs(cfg, state)
    assert sorted(got) == sorted(want) == sorted(loop)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-12 * np.abs(w).max(), err_msg=key)
        np.testing.assert_allclose(g, loop[key], rtol=1e-10, atol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("variant", VARIANTS)
def test_rhs_f32_matches_jax(variant):
    cfg = DEMConfig(variant=variant, n=12)
    state = moving_state(cfg)
    want = jdem.make_dem_rhs(jdem.DEMConfig(variant=variant, n=12),
                             dtype=jnp.float32)(
        0.0, to_jax(state, jnp.float32))
    got = make_dem_rhs(cfg, dtype=torch.float32, device="cpu")(
        0.0, to_torch(state, torch.float32))
    for key in want:
        w = np.asarray(want[key], np.float64)
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy().astype(np.float64), w,
                                   rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=key)


def test_rhs_refuses_cell_strategies_and_a_missing_gpu(monkeypatch):
    """cell_roll is not ported (its pairs are cell_list's, in a TPU roll
    layout) and names cell_lanes, which runs (tests/test_torch_dem_cells.py);
    'cuda' without a GPU raises."""
    with pytest.raises(ValueError, match="use 'cell_lanes'"):
        make_dem_rhs(DEMConfig(n=12), neighbor="cell_roll", device="cpu")
    assert make_dem_rhs(DEMConfig(n=12), neighbor="cell_lanes",
                        device="cpu").neighbor_struct.capacity == 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        make_dem_rhs(DEMConfig(n=12))


class TestTwoSpheres:
    """tests/test_dem.py's closed-form cases, on the port."""

    def test_head_on_repulsion_symmetry(self):
        cfg = DEMConfig(variant="friction_angular", n=2,
                        gravity=(0.0, 0.0, 0.0))
        y = {"pos": np.array([[0.4, 0.5, 0.5],
                              [0.4 + 2 * cfg.r * 0.95, 0.5, 0.5]]),
             "vel": np.array([[1.0, 0, 0], [-1.0, 0, 0]]),
             "angvel": np.zeros((2, 3))}
        out = make_dem_rhs(cfg, device="cpu")(0.0, to_torch(y))
        acc = out["vel"].numpy()
        np.testing.assert_allclose(acc[0], -acc[1], atol=1e-12)
        assert acc[0][0] < 0
        np.testing.assert_allclose(acc[:, 1:], 0.0, atol=1e-9)
        np.testing.assert_allclose(out["angvel"].numpy(), 0.0, atol=1e-9)

    def test_closed_form_normal_force(self):
        cfg = DEMConfig(variant="basic", n=2, gravity=(0.0, 0.0, 0.0))
        gap = 0.9 * 2 * cfg.r
        y = {"pos": np.array([[0.5, 0.5, 0.5], [0.5 + gap, 0.5, 0.5]]),
             "vel": np.zeros((2, 3))}
        out = make_dem_rhs(cfg, device="cpu")(0.0, to_torch(y))
        dist = gap + cfg.zero
        surf = dist - 2 * cfg.r
        CF = cfg.collision_force_multiplier * np.exp(
            -cfg.collision_force_exponent * surf)
        reb = cfg.COR**2 + 0.5 * (1 - cfg.COR**2)
        np.testing.assert_allclose(float(out["vel"][0][0]),
                                   -CF * reb * gap / dist, rtol=1e-12)

    def test_spinning_sphere_on_floor_rolls(self):
        cfg = DEMConfig(variant="friction_angular", n=1,
                        gravity=(0.0, 0.0, 0.0))
        y = {"pos": np.array([[0.5, 0.5, cfg.r * 0.98]]),
             "vel": np.zeros((1, 3)),
             "angvel": np.array([[0.0, 5.0, 0.0]])}
        out = make_dem_rhs(cfg, device="cpu")(0.0, to_torch(y))
        acc = out["vel"].numpy()[0]
        angacc = out["angvel"].numpy()[0]
        assert acc[0] > 0
        assert abs(acc[1]) < 1e-12
        assert angacc[1] < 0
        assert float(out["pos"][0][0]) == 0.0

    def test_wb_no_force_without_overlap(self):
        cfg = DEMConfig(variant="basic_WB", n=2, gravity=(0.0, 0.0, 0.0))
        y = {"pos": np.array([[0.5, 0.5, 0.5],
                              [0.5 + 2.05 * cfg.r, 0.5, 0.5]]),
             "vel": np.zeros((2, 3))}
        out = make_dem_rhs(cfg, device="cpu")(0.0, to_torch(y))
        np.testing.assert_allclose(out["vel"].numpy(), 0.0, atol=1e-15)


class TestIconds:
    def test_dense_packing_inside_vessel(self):
        cfg = DEMConfig(variant="friction_angular", n=200)
        y, color = icond_dense(cfg, seed=0)
        assert y["pos"].shape == (200, 3)
        assert np.all(y["pos"][:, :2] >= 0)
        assert np.all(y["pos"][:, :2] <= cfg.R)
        assert np.all(y["pos"][:, 2] >= cfg.h0)
        np.testing.assert_array_equal(color, y["pos"][:, 2])
        assert "angvel" in y

    def test_sparse_stacking(self):
        cfg = DEMConfig(variant="basic", n=10)
        y, _ = icond_sparse(cfg, seed=0)
        assert "angvel" not in y
        np.testing.assert_allclose(np.diff(y["pos"][:, 2]), 2 * cfg.r)

    def test_min_pair_distance_dense(self):
        cfg = DEMConfig(variant="basic", n=200)
        y, _ = icond_dense(cfg, seed=1)
        d = np.linalg.norm(
            y["pos"][:, None, :] - y["pos"][None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        assert d.min() > 2.5 * cfg.r - 0.5 * cfg.r

    @pytest.mark.parametrize("variant", ["basic", "friction_angular"])
    def test_iconds_equal_jax(self, variant):
        cfg = DEMConfig(variant=variant, n=30)
        jcfg = jdem.DEMConfig(variant=variant, n=30)
        for mine, theirs in ((icond_dense(cfg, seed=2),
                              jdem.icond_dense(jcfg, seed=2)),
                             (icond_sparse(cfg, seed=2),
                              jdem.icond_sparse(jcfg, seed=2)),
                             (icond_2spheres(cfg),
                              jdem.icond_2spheres(jcfg))):
            (y, c), (yj, cj) = mine, theirs
            assert sorted(y) == sorted(yj)
            for k in y:
                np.testing.assert_array_equal(y[k], yj[k])
            np.testing.assert_array_equal(c, cj)


class TestIntegration:
    def test_bounce_loses_energy(self):
        cfg = DEMConfig(variant="basic", n=1)
        y0 = to_torch({"pos": [[0.5, 0.5, 0.5]], "vel": [[0.0, 0.0, 0.0]]})
        state = merson_init(y0, 0.0, cfg.ht)
        state, status = merson_solve(
            make_dem_rhs(cfg, device="cpu"), state, 0.6,
            MersonParams(delta=cfg.delta, h_min=cfg.ht_min))
        assert status == 0
        z = float(state.y["pos"][0, 2])
        vz = float(state.y["vel"][0, 2])
        assert z > cfg.r * 0.5
        assert z + max(vz, 0.0) ** 2 / (2 * 9.81) < 0.45

    def test_two_sphere_merson_run(self):
        cfg = DEMConfig(variant="friction_angular", n=2,
                        gravity=(0.0, 0.0, 0.0))
        y0, _ = icond_2spheres(cfg)
        state = merson_init(to_torch(y0), 0.0, cfg.ht)
        state, status = merson_solve(
            make_dem_rhs(cfg, device="cpu"), state, 1.0,
            MersonParams(delta=cfg.delta, h_min=cfg.ht_min))
        assert status == 0 and state.steps > 0
        assert np.all(np.isfinite(state.y["pos"].numpy()))


@pytest.mark.parametrize("variant,tf", [(v, 0.3) for v in VARIANTS]
                         + [("friction_angular", 0.6)])
def test_merson_window_step_counts_equal_jax(variant, tf):
    """A Merson window on the dict state (the dense bed of 12 spheres,
    seed 5, the app case of tests/test_dem.py, to t = 0.3; the production
    variant also to t = 0.6, through the bed's first impacts on the
    floor): the same successful and attempted step counts as JAX's, the
    same final t, and the state to 1e-5 of each leaf's largest value.

    The RHS differs from JAX's in the last bits (sums over the neighbours
    in another order), and the contacts amplify such differences: to
    t = 0.6 basic and friction take other counts than JAX (my CPU run:
    226/255 against 222/245, 315/372 against 313/370; ROADMAP Queue 3),
    as two JAX builds would.  In free fall eps is rounding noise of either
    framework, and the steps it sets differ too."""
    cfg = DEMConfig(variant=variant, n=12)
    jcfg = jdem.DEMConfig(variant=variant, n=12)
    y0, _ = icond_dense(cfg, seed=5)
    jst, jstatus = jax.jit(lambda st: jsolve(
        jdem.make_dem_rhs(jcfg), st, tf,
        JParams(delta=cfg.delta, h_min=cfg.ht_min)))(
        jinit(to_jax(y0), 0.0, cfg.ht))
    st, status = merson_solve(make_dem_rhs(cfg, device="cpu"),
                              merson_init(to_torch(y0), 0.0, cfg.ht), tf,
                              MersonParams(delta=cfg.delta,
                                           h_min=cfg.ht_min))
    assert status == int(jstatus) == 0
    assert (st.steps, st.steps_total) == (int(jst.steps),
                                          int(jst.steps_total))
    assert st.t == pytest.approx(float(jst.t), rel=1e-12)
    for k in y0:
        want = np.asarray(jst.y[k])
        np.testing.assert_allclose(st.y[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_dem_state_from_reference_continues_jax():
    """A JAX state carried across continues with JAX's step counts."""
    cfg = DEMConfig(variant="friction_angular", n=12)
    jcfg = jdem.DEMConfig(variant="friction_angular", n=12)
    y0, _ = icond_dense(cfg, seed=5)
    jparams = JParams(delta=cfg.delta, h_min=cfg.ht_min)
    jrhs = jdem.make_dem_rhs(jcfg)
    run = jax.jit(lambda st, tf: jsolve(jrhs, st, tf, jparams))
    mid, _ = run(jinit(to_jax(y0), 0.0, cfg.ht), 0.12)
    end, _ = run(mid, 0.24)
    st = dem_state_from_reference(
        {k: np.asarray(v) for k, v in mid.y.items()}, mid.t, mid.h,
        mid.steps, mid.steps_total)
    assert st.y["pos"].dtype == torch.float64 and st.steps == int(mid.steps)
    st, status = merson_solve(make_dem_rhs(cfg, device="cpu"), st, 0.24,
                              MersonParams(delta=cfg.delta,
                                           h_min=cfg.ht_min))
    assert status == 0
    assert (st.steps, st.steps_total) == (int(end.steps),
                                          int(end.steps_total))
    with pytest.raises(ValueError, match="pos, vel"):
        dem_state_from_reference({"pos": np.zeros((2, 3))}, 0, 1, 0, 0)


def test_merson_dict_nan_rejects_the_attempt():
    """A NaN in one leaf makes the dict's eps NaN (torch.maximum
    propagates it, as jnp.maximum does): with handle_nan the attempt is
    rejected and h cut tenfold; the run then equals one started at h/10
    plus that attempt."""
    calls = []

    def rhs(t, y):
        calls.append(t)
        out = {"a": -y["a"], "b": -2.0 * y["b"]}
        if len(calls) <= 5:
            out["b"] = torch.full_like(y["b"], float("nan"))
        return out

    def clean(t, y):
        return {"a": -y["a"], "b": -2.0 * y["b"]}

    y0 = {"a": torch.ones(3, dtype=torch.float64),
          "b": torch.ones(2, dtype=torch.float64)}
    prm = MersonParams(delta=1e-8, handle_nan=True)
    st, status = merson_solve(rhs, merson_init(y0, 0.0, 0.1), 1.0, prm)
    ref, _ = merson_solve(clean, merson_init(y0, 0.0, 0.01), 1.0, prm)
    assert status == 0
    assert (st.steps, st.steps_total) == (ref.steps, ref.steps_total + 1)
    for k in y0:
        assert torch.equal(st.y[k], ref.y[k])


class TestRK4:
    """tests/test_merson.py's RK4 cases, against JAX's values."""

    def test_fixed_step_exact_cubic(self):
        t, y = rk4_solve(lambda t, y: torch.full_like(y, 3.0 * t**2), 0.0,
                         torch.zeros(1, dtype=torch.float64), 0.25, 8)
        tj, yj = jrk4(lambda t, y: jnp.full_like(y, 3.0 * t**2), 0.0,
                      jnp.zeros((1,), jnp.float64), 0.25, 8)
        assert t == pytest.approx(2.0)
        assert float(y[0]) == pytest.approx(8.0, rel=1e-12)
        assert float(y[0]) == pytest.approx(float(yj[0]), rel=1e-15)

    def test_decay_order4_on_a_dict(self):
        errs = []
        for n in (16, 32):
            t, y = rk4_solve(lambda t, y: {"u": -y["u"]}, 0.0,
                             {"u": torch.ones(1, dtype=torch.float64)},
                             1.0 / n, n)
            tj, yj = jrk4(lambda t, y: {"u": -y["u"]}, 0.0,
                          {"u": jnp.ones((1,), jnp.float64)}, 1.0 / n, n)
            assert float(y["u"][0]) == pytest.approx(float(yj["u"][0]),
                                                     rel=1e-14)
            errs.append(abs(float(y["u"][0]) - math.exp(-1.0)))
        assert errs[0] / errs[1] > 12


class TestDopri:
    """tests/test_analysis.py's Dormand-Prince cases, against JAX's step
    counts and values."""

    def test_exponential(self):
        res = dopri45_solve(lambda t, y: -y, 0.0,
                            torch.ones(1, dtype=torch.float64), 1.0, 0.1,
                            rtol=1e-9, atol=1e-12)
        jres = jdopri(lambda t, y: -y, 0.0, jnp.ones((1,), jnp.float64),
                      1.0, 0.1, rtol=1e-9, atol=1e-12)
        assert res.t == pytest.approx(1.0)
        assert float(res.y[0]) == pytest.approx(math.exp(-1.0), rel=1e-8)
        assert (res.steps, res.steps_total) == (int(jres.steps),
                                                int(jres.steps_total))
        assert float(res.y[0]) == pytest.approx(float(jres.y[0]), rel=1e-14)

    def test_oscillator_tolerance_scaling(self):
        f = lambda t, y: torch.stack([y[1], -y[0]])
        fj = lambda t, y: jnp.stack([y[1], -y[0]])
        y0 = torch.tensor([1.0, 0.0], dtype=torch.float64)
        counts = []
        for rtol, atol in ((1e-4, 1e-6), (1e-9, 1e-12)):
            res = dopri45_solve(f, 0.0, y0, 10.0, 0.1, rtol=rtol, atol=atol)
            jres = jdopri(fj, 0.0, jnp.asarray([1.0, 0.0], jnp.float64),
                          10.0, 0.1, rtol=rtol, atol=atol)
            assert (res.steps, res.steps_total) == (int(jres.steps),
                                                    int(jres.steps_total))
            counts.append(res.steps)
        assert counts[1] > counts[0]
        assert float(res.y[0]) == pytest.approx(math.cos(10.0), abs=1e-7)

    def test_cross_validates_merson_on_dem(self):
        """The two integrators agree on a small DEM drop (the reference's
        C-vs-MATLAB redundancy check); dopri's counts equal JAX's."""
        cfg = DEMConfig(variant="basic", n=1)
        y0 = {"pos": [[0.5, 0.5, 0.3]], "vel": [[0.0, 0.0, 0.0]]}
        rhs = make_dem_rhs(cfg, device="cpu")
        res = dopri45_solve(rhs, 0.0, to_torch(y0), 0.22, 0.01, rtol=1e-7,
                            atol=1e-9)
        jres = jdopri(jdem.make_dem_rhs(jdem.DEMConfig(variant="basic", n=1)),
                      0.0, to_jax(y0), 0.22, 0.01, rtol=1e-7, atol=1e-9)
        assert (res.steps, res.steps_total) == (int(jres.steps),
                                                int(jres.steps_total))
        st, status = merson_solve(rhs, merson_init(to_torch(y0), 0.0, 0.01),
                                  0.22, MersonParams(delta=1e-6,
                                                     h_min=1e-12))
        assert status == 0
        np.testing.assert_allclose(res.y["pos"].numpy(),
                                   st.y["pos"].numpy(), atol=1e-4)
        np.testing.assert_allclose(res.y["vel"].numpy(),
                                   st.y["vel"].numpy(), atol=1e-3)
