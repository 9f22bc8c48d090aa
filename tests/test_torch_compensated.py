"""The port's compensated (double-f32) commit against the JAX package.

``TorchDeltaAttemptComp`` against ``XlaDeltaAttemptComp``, and the port's
``DeltaAttemptComp`` (the ``emit="dy"`` delta tail's plain version on the
CPU) against the JAX ``DeltaAttemptComp`` in interpret mode, with the
checks of tests/test_delta_form.py::TestCompensatedCommit; a 30-attempt
solve against JAX's; and the port's app with ``compensated_commit 1``
against the JAX app's compensated run.

Tolerances: dy to rtol 1e-5 / atol 1e-6 and eps to 1e-3 relative (float32
sums taken in other orders); the committed hi + lo equals the exact f64
sum of hi and dy to 1e-12 (TwoSum is exact); app step counts within 2%.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.apps.intertrack import main as jax_main
from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
from porousfreezethaw_tpu.models.freezing.delta import XlaDeltaAttemptComp
from porousfreezethaw_tpu.ops.pallas import stencil as jst
from porousfreezethaw_tpu.solvers import merson as jm
from porousfreezethaw_tpu_torch.apps.intertrack import main as torch_main
from porousfreezethaw_tpu_torch.convert import params_from_reference
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.io.netcdf3 import read_netcdf
from porousfreezethaw_tpu_torch.models.freezing.delta import (
    TorchDeltaAttemptComp)
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from porousfreezethaw_tpu_torch.solvers import merson as tm
from tests.test_freezing_equation import default_params
from tests.test_intertrack_app import BASE

torch.set_num_threads(1)

SHAPE = (14, 10, 12)     # (n3, n2, n1), the case of tests/test_delta_form.py
T, H = 100.0, 0.05


@pytest.fixture(scope="module")
def case():
    jprm = default_params()
    prm = params_from_reference(jprm.as_dict())
    jgeom = JGeom(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    rng = np.random.RandomState(7)
    w = np.stack([273.15 + 10 * (rng.random_sample(SHAPE) - 0.5),
                  rng.random_sample(SHAPE),
                  0.6 * rng.random_sample(SHAPE)]).astype(np.float32)
    return jprm, prm, jgeom, geom, w


def _eps_close(a, b):
    assert abs(a - b) <= 1e-3 * max(abs(a), abs(b)) + 1e-7, (a, b)


def _check_commit(comp, y5, dy):
    """Accept: hi + lo equals the exact f64 sum of hi and dy, gl is kept;
    reject keeps everything."""
    before = y5.clone()
    hi0 = before[:2].double()
    exact = hi0 + dy.double()
    kept = comp.commit((y5.clone(), dy), False)
    assert torch.equal(kept, before)
    got = comp.commit((y5.clone(), dy), True)
    assert got.shape == before.shape
    torch.testing.assert_close(got[:2].double() + got[3:].double(), exact,
                               rtol=0, atol=1e-12)
    assert torch.equal(got[2], before[2])
    return got


def test_torch_comp_matches_xla_comp(case):
    jprm, prm, jgeom, geom, w = case
    xla = XlaDeltaAttemptComp(jgeom, jprm, 0)
    y5x = xla.pack(jnp.asarray(w))
    (_, dy_x), eps_x = xla.attempt(T, H, y5x)

    comp = TorchDeltaAttemptComp(geom, prm, 0, "cpu")
    y5 = comp.pack(torch.from_numpy(w))
    assert y5.shape[0] == 5 and comp.pack(y5) is y5     # idempotent
    assert torch.equal(y5[3:], torch.zeros_like(y5[3:]))
    (_, dy), eps = comp.attempt(T, H, y5)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_x), rtol=1e-5,
                               atol=1e-6)
    _eps_close(float(eps.max()), float(jnp.max(eps_x)))
    got = _check_commit(comp, y5, dy)
    want = np.asarray(xla.commit((y5x, dy_x), jnp.asarray(True)))
    np.testing.assert_allclose(got[:3].numpy(), want[:3], rtol=1e-5,
                               atol=1e-6)


def test_port_comp_matches_pallas_comp(case):
    """The port's DeltaAttemptComp (plain versions on the CPU) against the
    JAX DeltaAttemptComp in interpret mode, and against the port's own
    TorchDeltaAttemptComp; pack copies, so the caller's state is kept."""
    jprm, prm, jgeom, geom, w = case
    pal = jst.make_delta_attempt(jgeom, jprm, 0, bz=2, interpret=True,
                                 compensated=True)
    y5p = pal.pack(jst.pad_state(jnp.asarray(w), jgeom))
    (_, dy_p), eps_p = pal.attempt(jnp.asarray(T, jnp.float64),
                                   jnp.asarray(H, jnp.float64), y5p)
    want_dy = np.asarray(jst.unpad_state(dy_p, jgeom))

    att = st.DeltaAttemptComp(geom, prm, 0)
    y0 = torch.from_numpy(w.copy())
    y5 = att.pack(y0)
    assert y5.shape == (5,) + SHAPE and y5.is_contiguous()
    y5b = att.pack(y5)
    assert y5b is not y5 and torch.equal(y5b, y5)       # copies a 5-plane
    (carry, dy), eps = att.attempt(T, H, y5)
    assert carry is y5
    np.testing.assert_allclose(dy.numpy(), want_dy, rtol=1e-5, atol=1e-6)
    _eps_close(float(eps.max()), float(jnp.max(eps_p)))

    tcomp = TorchDeltaAttemptComp(geom, prm, 0, "cpu")
    (_, dy_t), eps_t = tcomp.attempt(T, H, tcomp.pack(torch.from_numpy(w)))
    np.testing.assert_allclose(dy.numpy(), dy_t.numpy(), rtol=1e-5,
                               atol=1e-6)
    _eps_close(float(eps.max()), float(eps_t.max()))

    got = _check_commit(att, y5, dy)
    com_p = pal.commit((y5p, dy_p), jnp.asarray(True))
    np.testing.assert_allclose(
        got[:3].numpy(), np.asarray(jst.unpad_state(com_p[:3], jgeom)),
        rtol=1e-5, atol=1e-6)
    # the commit is in place on the packed copy
    out = att.commit((y5, dy), True)
    assert out is y5 and torch.equal(out, got)
    assert torch.equal(y0, torch.from_numpy(w))


def test_comp_solve_matches_jax(case):
    """30 attempts of merson_solve through the port's DeltaAttemptComp and
    through the JAX one (interpret mode): the same successful and attempted
    step counts; t to 1e-2 relative, because each new h scales with
    eps^-0.2 and the two eps differ by up to 1e-3 relative (float32 sums in
    other orders), which 30 steps accumulate; the states to 1e-3 of their
    scale.  The solve leaves its input state untouched."""
    jprm, prm, jgeom, geom, w = case
    params = dict(delta=1e-3, h_min=1e-9, max_steps=30)
    pal = jst.make_delta_attempt(jgeom, jprm, 0, bz=2, interpret=True,
                                 compensated=True)
    sj, _ = jm.merson_solve(
        None, jm.merson_init(jst.pad_state(jnp.asarray(w), jgeom), 0.0, 1e-4),
        1e9, jm.MersonParams(**params), attempt_fn=pal)

    y0 = torch.from_numpy(w.copy())
    st_, _ = tm.merson_solve(None, tm.merson_init(y0, 0.0, 1e-4), 1e9,
                             tm.MersonParams(**params),
                             attempt_fn=st.DeltaAttemptComp(geom, prm, 0))
    assert torch.equal(y0, torch.from_numpy(w))
    assert st_.steps_total == int(sj.steps_total) == 30
    assert st_.steps == int(sj.steps)
    assert st_.t == pytest.approx(float(sj.t), rel=1e-2)
    assert st_.y.shape == (5,) + SHAPE
    got = st_.y[:3].numpy()
    want = np.asarray(jst.unpad_state(sj.y[:3], jgeom))
    for v in range(2):
        assert np.abs(got[v] - want[v]).max() <= 1e-3 * np.abs(want[v]).max()
    np.testing.assert_array_equal(got[2], want[2])
    # continuing a solve carries the lo planes
    st2, _ = tm.merson_solve(None, st_, 1e9, tm.MersonParams(**params),
                             attempt_fn=st.DeltaAttemptComp(geom, prm, 0))
    assert st2.y.shape == (5,) + SHAPE and st2.steps > st_.steps


# --------------------------------------------------------------------------
# the app
# --------------------------------------------------------------------------

COMP = BASE + "\ncompensated_commit 1\n"


def run(main, out_dir, params_text, argv=()):
    out_dir.mkdir(parents=True, exist_ok=True)
    pfile = out_dir / "Params"
    pfile.write_text(params_text)
    old = os.environ.get("OUTPUT")
    os.environ["OUTPUT"] = str(out_dir)
    try:
        assert main([str(pfile), *argv]) == 0
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
    log = (out_dir / "intertrack.log").read_text()
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    assert m, log[-1000:]
    return log, int(m[1]), int(m[2])


def test_app_compensated_commit_matches_jax_app(tmp_path, monkeypatch):
    monkeypatch.setenv("PFT_FUSED_INTERPRET", "1")
    jlog, s_j, a_j = run(jax_main, tmp_path / "jax", COMP,
                         ("--precision", "f32"))
    assert "(compensated commit)" in jlog
    tlog, s_t, a_t = run(torch_main, tmp_path / "port", COMP,
                         ("--precision", "f32", "--device", "cpu"))
    assert ("Increment-form (delta) attempt kernels: ON (compensated "
            "commit) (cpu)") in tlog
    assert abs(s_t - s_j) <= 0.02 * s_j and abs(a_t - a_j) <= 0.02 * a_j
    for name in ("image.000.ncd", "image.001.ncd", "image.002.ncd"):
        dt = read_netcdf(str(tmp_path / "port" / name))
        dj = read_netcdf(str(tmp_path / "jax" / name))
        assert set(dt.variables) == set(dj.variables)
        for v in ("u", "p", "gl"):
            ft, fj = np.asarray(dt.variables[v]), np.asarray(dj.variables[v])
            assert ft.shape == fj.shape and np.isfinite(ft).all()
        np.testing.assert_allclose(np.asarray(dt.variables["u"]),
                                   np.asarray(dj.variables["u"]),
                                   rtol=0, atol=1e-3)


def test_app_reads_compensated_commit(tmp_path, monkeypatch):
    """``compensated_commit 1`` selects DeltaAttemptComp: every attempt
    commits through its TwoSum commit; without it, no attempt does."""
    from porousfreezethaw_tpu_torch.apps import intertrack
    commits = []
    orig = intertrack.DeltaAttemptComp.commit

    def counting(self, carry_spec, accept):
        commits.append(accept)
        return orig(self, carry_spec, accept)

    monkeypatch.setattr(intertrack.DeltaAttemptComp, "commit", counting)
    argv = ("--precision", "f32", "--device", "cpu")
    _, _, attempts = run(torch_main, tmp_path / "plain", BASE, argv)
    assert commits == [] and attempts > 0
    _, steps, attempts = run(torch_main, tmp_path / "comp", COMP, argv)
    assert len(commits) == attempts and sum(commits) == steps
