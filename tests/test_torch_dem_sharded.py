"""The port's particle-sharded DEM on virtual CPU shards: ``shard_dem_state``
and ``gather_dem_state``, the sharded dense right-hand side
(``make_dem_rhs(..., mesh=)``) bit for bit against the single-device one
at p2, p4 and p8, and the Merson controller on the list of shard dicts:
the single-device step counts and state bits, and the JAX package's
single-device counts over tests/test_parallel.py's window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.models import dem as jdem
from porousfreezethaw_tpu.solvers import (
    MersonParams as JParams, merson_init as jinit, merson_solve as jsolve)
from porousfreezethaw_tpu_torch.models.dem import (
    DEMConfig, icond_dense, make_dem_rhs)
from porousfreezethaw_tpu_torch.parallel import (
    dem_sharding, gather_dem_state, make_mesh, shard_dem_state)
from porousfreezethaw_tpu_torch.solvers import (
    MersonParams, merson_init, merson_solve)
from porousfreezethaw_tpu_torch.solvers.merson import _max_of_leaves

torch.set_num_threads(1)

VARIANTS = ["basic", "basic_WB", "friction", "friction_angular"]
N = 16


def setup(variant="friction_angular", moving=True):
    """tests/test_parallel.py's bed of 16 spheres (seed 3); moving: random
    velocities and spins and two spheres in contact, so every pair term
    is live."""
    cfg = DEMConfig(variant=variant, n=N, r=0.1, T=0.5, snapshots=3)
    y, _ = icond_dense(cfg, seed=3)
    if moving:
        rng = np.random.RandomState(4)
        y["vel"] = rng.standard_normal((N, 3))
        if cfg.angular:
            y["angvel"] = 5.0 * rng.standard_normal((N, 3))
        y["pos"][1] = y["pos"][0] + [2 * cfg.r * 0.9, 0, 0]
    return cfg, {k: torch.tensor(v) for k, v in y.items()}


def test_shard_gather_round_trip():
    _, y = setup()
    mesh = make_mesh("p4", device="cpu")
    assert mesh.device_list() == [torch.device("cpu")] * 4
    shards = shard_dem_state(y, mesh)
    assert len(shards) == 4
    for i, s in enumerate(shards):
        assert sorted(s) == sorted(y)
        for k, v in s.items():
            assert v.is_contiguous() and v.shape == (4, 3)
            assert torch.equal(v, y[k][4 * i:4 * (i + 1)])
    back = gather_dem_state(shards)
    assert all(torch.equal(back[k], y[k]) for k in y)
    shards[0]["pos"].zero_()                    # copies, not views
    assert y["pos"][0].abs().max() > 0
    assert dem_sharding(mesh, 16) == [slice(0, 4), slice(4, 8),
                                      slice(8, 12), slice(12, 16)]


def test_sharding_errors_match_jax():
    from porousfreezethaw_tpu.parallel.sharding import (
        make_mesh as jmesh, shard_dem_state as jshard)
    _, y = setup()
    with pytest.raises(ValueError) as jerr:
        jshard({k: jnp.asarray(v.numpy()[:15]) for k, v in y.items()},
               jmesh("p2", jax.devices()[:2]))
    with pytest.raises(ValueError) as err:
        shard_dem_state({k: v[:15] for k, v in y.items()},
                        make_mesh("p2", device="cpu"))
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="one axis 'p'"):
        dem_sharding(make_mesh("z2", device="cpu"), 16)


@pytest.mark.parametrize("spec", ["p2", "p4", "p8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_rhs_bitwise(variant, spec):
    cfg, y = setup(variant)
    want = make_dem_rhs(cfg, device="cpu")(0.0, y)
    mesh = make_mesh(spec, device="cpu")
    rhs = make_dem_rhs(cfg, mesh=mesh)
    assert rhs.neighbor_struct is None
    out = rhs(0.0, shard_dem_state(y, mesh))
    assert len(out) == mesh.size
    got = gather_dem_state(out)
    for k in want:
        assert got[k].dtype == torch.float64
        assert torch.equal(got[k], want[k]), k


def test_sharded_rhs_refuses_a_wrong_shard_count():
    cfg, y = setup()
    rhs = make_dem_rhs(cfg, mesh=make_mesh("p4", device="cpu"))
    with pytest.raises(ValueError, match="2 shards for a mesh of 4"):
        rhs(0.0, shard_dem_state(y, make_mesh("p2", device="cpu")))


@pytest.fixture(scope="module")
def jax_counts():
    """JAX's single-device counts of tests/test_parallel.py's solve."""
    jcfg = jdem.DEMConfig(variant="friction_angular", n=N, r=0.1, T=0.5,
                          snapshots=3)
    y0, _ = jdem.icond_dense(jcfg, seed=3)
    st, status = jax.jit(lambda s: jsolve(
        jdem.make_dem_rhs(jcfg), s, 0.25,
        JParams(delta=jcfg.delta, h_min=jcfg.ht_min, max_steps=4000)))(
        jinit({k: jnp.asarray(v) for k, v in y0.items()}, 0.0, jcfg.ht))
    assert int(status) == 0
    return int(st.steps), int(st.steps_total)


def test_merson_mesh_invariant(jax_counts):
    """tests/test_parallel.py's solve to t = 0.25 at p2 and p8: the
    single-device counts and state bits (each shard's axpys are the
    single-device ones, row for row), and JAX's counts."""
    cfg, y0 = setup(moving=False)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min, max_steps=4000)
    base, status = merson_solve(make_dem_rhs(cfg, device="cpu"),
                                merson_init(y0, 0.0, cfg.ht), 0.25, params)
    assert status == 0 and base.steps > 3
    assert (base.steps, base.steps_total) == jax_counts
    for spec in ("p2", "p8"):
        mesh = make_mesh(spec, device="cpu")
        st, status = merson_solve(make_dem_rhs(cfg, mesh=mesh),
                                  merson_init(shard_dem_state(y0, mesh), 0.0,
                                              cfg.ht), 0.25, params)
        assert status == 0
        assert (st.steps, st.steps_total, st.t, st.h) == (
            base.steps, base.steps_total, base.t, base.h)
        got = gather_dem_state(st.y)
        assert all(torch.equal(got[k], base.y[k]) for k in got)


def test_eps_of_shards_propagates_nan():
    """eps over a list of shard dicts is the max of the shards' maxima, a
    NaN in any shard's leaf making it NaN (as jnp.maximum)."""
    leaves = [{"pos": torch.tensor(1.0), "vel": torch.tensor(3.0)},
              {"pos": torch.tensor(2.0), "vel": torch.tensor(0.5)}]
    assert float(_max_of_leaves(leaves)) == 3.0
    leaves[1]["pos"] = torch.tensor(float("nan"))
    assert torch.isnan(_max_of_leaves(leaves))
    cfg, y0 = setup()
    mesh = make_mesh("p2", device="cpu")
    ys = shard_dem_state(y0, mesh)
    ys[1]["vel"][0, 0] = float("nan")
    st, status = merson_solve(
        make_dem_rhs(cfg, mesh=mesh), merson_init(ys, 0.0, 1e-3), 0.01,
        MersonParams(delta=cfg.delta, h_min=cfg.ht_min, handle_nan=True,
                     max_steps=3))
    assert st.steps == 0 and st.steps_total == 3
    assert st.h == pytest.approx(1e-6)          # three NaN backoffs of /10
