"""The port's plain right-hand side over a mesh with explicit halo copies
(``parallel/halo.py``) on virtual CPU shards: bit for bit against the
port's single-device ``make_rhs`` in f64 and f32, calc modes 0, 1 and 2,
z and y windows (even, uneven, one plane thick), a noise field and both
sides of the Dirichlet switch; within 1e-13 (rtol, atol 1e-15, the bound
of tests/test_parallel.py) of the JAX package's ``make_rhs``; the halo
copies themselves; uneven z windows through shard/gather; and a Merson
solve with the single-device counts and state bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.models.freezing.equation import (
    make_rhs as jax_make_rhs)
from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config import parse_param_file
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing.equation import make_rhs
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    FreezingParams)
from porousfreezethaw_tpu_torch.parallel import (
    gather_freezing_state, make_mesh, shard_freezing_state)
from porousfreezethaw_tpu_torch.parallel.halo import (
    halo_exchange_y, halo_exchange_z, make_halo_rhs)
from porousfreezethaw_tpu_torch.solvers import (
    MersonParams, merson_init, merson_solve)

torch.set_num_threads(1)

SHAPE = (11, 7, 5)                # (n3, n2, n1): no mesh below divides 11
SPECS = ["z2", "z3", "z2,y2", "y3", "z11", "z4,y3"]


@pytest.fixture(scope="module")
def case():
    pf = parse_param_file(freezing_params_text(100, 0),
                          env={"OUTPUT": "unused"})
    prm = FreezingParams.from_dict(pf.vars)
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    rng = np.random.default_rng(5)
    w = np.stack([rng.uniform(260, 280, SHAPE), rng.uniform(0, 1, SHAPE),
                  rng.uniform(0, 0.6, SHAPE)])
    noise = 0.01 * (rng.random(SHAPE) - 0.5)
    return prm, geom, w, noise


def sharded(w, mesh):
    return shard_freezing_state(torch.from_numpy(w), mesh)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_halo_rhs_bitwise(case, dtype, mode, spec):
    prm, geom, w, noise = case
    w, noise = w.astype(dtype), noise.astype(dtype)
    mesh = make_mesh(spec, device="cpu")
    for nz in (None, noise):
        ref = make_rhs(geom, prm, mode, "cpu", noise=nz)
        rhs = make_halo_rhs(geom, prm, mode, mesh, noise=nz)
        for t in (prm.phase_switch_time - 1.0, prm.phase_switch_time + 1.0):
            want = ref(t, torch.from_numpy(w))
            got = gather_freezing_state(rhs(t, sharded(w, mesh)), mesh)
            assert got.dtype == want.dtype
            assert torch.equal(got, want), (nz is not None, t)


@pytest.mark.parametrize("spec", ["z3", "z2,y2"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_halo_rhs_matches_jax(case, mode, spec):
    """Against the JAX package's make_rhs, f64, at both sides of the
    switch (tests/test_parallel.py's bound for its shard_map RHS)."""
    prm, geom, w, _ = case
    from porousfreezethaw_tpu.core.grid import GridGeometry as JGeom
    from porousfreezethaw_tpu.models.freezing.parameters import (
        FreezingParams as JParams)
    jrhs = jax_make_rhs(JGeom(geom.L1, geom.L2, geom.L3, geom.n1, geom.n2,
                              geom.n3),
                        JParams.from_dict(prm.as_dict()), mode)
    mesh = make_mesh(spec, device="cpu")
    rhs = make_halo_rhs(geom, prm, mode, mesh)
    for t in (prm.phase_switch_time - 1.0, prm.phase_switch_time + 1.0):
        want = np.asarray(jrhs(t, jnp.asarray(w)))
        got = gather_freezing_state(rhs(t, sharded(w, mesh)), mesh).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_halo_copies(case):
    """Each shard receives its neighbours' edge planes and rows on its
    device; a chain end receives nothing."""
    _, _, w, _ = case
    mesh = make_mesh("z3,y2", device="cpu")
    shards = sharded(w, mesh)
    from_z = halo_exchange_z(shards, mesh)
    from_y = halo_exchange_y(shards, mesh)
    # z windows 4, 4, 3; y windows 4, 3
    assert [s.shape[1:3] for s in shards] == [(4, 4), (4, 3)] * 2 + [
        (3, 4), (3, 3)]
    assert from_z[0][0] is None and from_z[4][1] is None
    assert torch.equal(from_z[2][0], torch.from_numpy(w[:, 3:4, :4]))
    assert torch.equal(from_z[2][1], torch.from_numpy(w[:, 8:9, :4]))
    assert from_y[0][0] is None and from_y[1][1] is None
    assert torch.equal(from_y[0][1], torch.from_numpy(w[:, :4, 4:5]))
    assert torch.equal(from_y[3][0], torch.from_numpy(w[:, 4:8, 3:4]))


def test_uneven_z_windows_round_trip(case):
    _, _, w, _ = case
    t = torch.from_numpy(w)
    mesh = make_mesh("z3,y2", device="cpu")
    shards = shard_freezing_state(t, mesh)
    zs = np.array_split(np.arange(SHAPE[0]), 3)
    ys = np.array_split(np.arange(SHAPE[1]), 2)
    for i, s in enumerate(shards):
        c = mesh.coords(i)
        assert torch.equal(s, t[:, zs[c["z"]]][:, :, ys[c["y"]]])
    assert torch.equal(gather_freezing_state(shards, mesh), t)
    with pytest.raises(ValueError, match="fewer planes"):
        shard_freezing_state(t, make_mesh("z12", device="cpu"))


def test_refusals(case):
    prm, geom, _, _ = case
    with pytest.raises(ValueError, match="not grid axes"):
        make_halo_rhs(geom, prm, 0, make_mesh("z2,p2", device="cpu"))
    with pytest.raises(ValueError, match="fewer planes or rows"):
        make_halo_rhs(geom, prm, 0, make_mesh("y8", device="cpu"))


@pytest.mark.parametrize("spec", ["z3", "z2,y2"])
def test_merson_through_halo(case, spec):
    """tests/test_parallel.py's solve (mode 0, delta 1e-3, to t = 30):
    the single-device counts, t, h and state bits."""
    prm, geom, w, _ = case
    params = MersonParams(delta=1e-3, h_min=1e-9)
    a, sa = merson_solve(make_rhs(geom, prm, 0, "cpu"),
                         merson_init(torch.from_numpy(w), 0.0, 1.0), 30.0,
                         params)
    mesh = make_mesh(spec, device="cpu")
    b, sb = merson_solve(make_halo_rhs(geom, prm, 0, mesh),
                         merson_init(sharded(w, mesh), 0.0, 1.0), 30.0,
                         params)
    assert sa == sb == 0 and a.steps > 3
    assert (a.steps, a.steps_total, a.t, a.h) == (b.steps, b.steps_total,
                                                  b.t, b.h)
    assert torch.equal(gather_freezing_state(b.y, mesh), a.y)


@pytest.mark.parametrize("spec", ["z3", "z2,y2"])
def test_merson_eps_mult_shards(case, spec):
    """A per-cell eps_mult: the list of its shards (split as the state)
    with the sharded state gives the counts, t, h and state bits of the
    whole tensor with the single-device state; a tensor against a list
    state is refused."""
    prm, geom, w, _ = case
    mult = np.random.default_rng(7).uniform(0.5, 2.0, (1,) + SHAPE)
    params = MersonParams(delta=1e-3, h_min=1e-9)
    a, sa = merson_solve(make_rhs(geom, prm, 0, "cpu"),
                         merson_init(torch.from_numpy(w), 0.0, 1.0), 30.0,
                         params, eps_mult=torch.from_numpy(mult))
    plain, _ = merson_solve(make_rhs(geom, prm, 0, "cpu"),
                            merson_init(torch.from_numpy(w), 0.0, 1.0),
                            30.0, params)
    mesh = make_mesh(spec, device="cpu")
    rhs = make_halo_rhs(geom, prm, 0, mesh)
    b, sb = merson_solve(rhs, merson_init(sharded(w, mesh), 0.0, 1.0), 30.0,
                         params, eps_mult=sharded(mult, mesh))
    assert sa == sb == 0
    assert (a.steps, a.steps_total) != (plain.steps, plain.steps_total)
    assert (a.steps, a.steps_total, a.t, a.h) == (b.steps, b.steps_total,
                                                  b.t, b.h)
    assert torch.equal(gather_freezing_state(b.y, mesh), a.y)
    with pytest.raises(ValueError, match="list of shards"):
        merson_solve(rhs, merson_init(sharded(w, mesh), 0.0, 1.0), 30.0,
                     params, eps_mult=torch.from_numpy(mult))
