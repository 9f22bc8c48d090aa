"""The port's DEM cell list (``neighbor='cell_lanes'`` and ``'cell_list'``)
against the JAX package's ``cell_lanes`` and against the port's dense
term, on the CPU, on the seeded states of tests/test_dem_celllist.py.

Tolerances: the right-hand side within 1e-12 (rtol and atol, as
tests/test_dem_celllist.py holds JAX's strategies to its dense oracle; the
strategies find the same pairs and sum them in other orders); the n = 27
settle's positions within rtol 1e-6, atol 1e-8 of dense's, its step count
within one of dense's (as there).  The occupancy and the overflow's NaN
are exact."""

import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.models import dem as jdem
from porousfreezethaw_tpu_torch.models.dem import (
    DEMConfig, default_cell_bounds, icond_dense, make_cell_list,
    make_dem_rhs)
from porousfreezethaw_tpu_torch.solvers import (
    MersonParams, merson_init, merson_solve)
from tests.test_dem_celllist import settled_like_state

torch.set_num_threads(1)

VARIANTS = ["basic", "basic_WB", "friction", "friction_angular"]


def to_torch(y):
    return {k: torch.tensor(np.asarray(v)) for k, v in y.items()}


def bench_cfg(n):
    """The bench's bed of n spheres: radius 0.1 * (200/n)^(1/3) past 400."""
    r = 0.1 if n <= 400 else 0.1 * (200.0 / n) ** (1.0 / 3.0)
    return DEMConfig(variant="friction_angular", n=n, r=r)


@pytest.mark.parametrize("neighbor", ["cell_lanes", "cell_list"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cells_match_jax_cell_lanes_and_dense(variant, neighbor):
    cfg = DEMConfig(variant=variant, n=100, r=0.1)
    y = settled_like_state(cfg)
    want = jdem.make_dem_rhs(jdem.DEMConfig(variant=variant, n=100, r=0.1),
                             neighbor="cell_lanes")(0.0, y)
    rhs = make_dem_rhs(cfg, neighbor=neighbor, device="cpu")
    got = rhs(0.0, to_torch(y))
    dense = make_dem_rhs(cfg, device="cpu")(0.0, to_torch(y))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


def test_default_cell_bounds_match_jax():
    for n in (200, 2000, 20000):
        cfg = bench_cfg(n)
        jcfg = jdem.DEMConfig(variant=cfg.variant, n=n, r=cfg.r)
        from porousfreezethaw_tpu.models.dem.forces import (
            default_cell_bounds as jbounds)
        assert default_cell_bounds(cfg) == jbounds(jcfg)


@pytest.mark.parametrize("n", [200, 2000, 20000])
def test_occupancy_equals_jax(n):
    """The dense icond's fullest cell, as JAX's cell_occupancy counts it,
    within half the default capacity (tests/test_dem_celllist.py
    test_dense_icond_fits_cell_bounds); and a packed random state's."""
    cfg = bench_cfg(n)
    jcfg = jdem.DEMConfig(variant=cfg.variant, n=n, r=cfg.r)
    jcells = jdem.make_cell_lanes(jcfg, capacity=16)
    cells = make_cell_list(cfg, capacity=16, device="cpu")
    y0, _ = icond_dense(cfg, seed=0)
    occ = cells.cell_occupancy(y0["pos"])
    assert occ == jcells.cell_occupancy(y0["pos"])
    assert occ <= cells.capacity // 2
    packed = settled_like_state(cfg, seed=1)["pos"]
    assert cells.cell_occupancy(np.asarray(packed)) == \
        jcells.cell_occupancy(packed)
    assert cells.dims == jcells.dims


def test_neighbor_struct():
    cfg = DEMConfig(n=100, r=0.1)
    assert make_dem_rhs(cfg, device="cpu").neighbor_struct is None
    rhs = make_dem_rhs(cfg, neighbor="cell_lanes", cell_capacity=8,
                       device="cpu")
    assert rhs.neighbor_struct.capacity == 8
    y = settled_like_state(cfg)
    assert 1 <= rhs.neighbor_struct.cell_occupancy(y["pos"]) <= 8


def test_overflow_poisons_and_cell_list_does_not():
    """tests/test_dem_celllist.py's overflow: 12 particles in one cell of
    capacity 8 make every acceleration NaN under cell_lanes (the guarded
    capacity, as in JAX); cell_list drops the excess silently; a capacity
    of 16 matches dense."""
    cfg = DEMConfig(variant="friction_angular", n=12, r=0.1)
    rng = np.random.RandomState(0)
    y = {"pos": 0.15 + 0.01 * rng.random_sample((12, 3)),
         "vel": rng.standard_normal((12, 3)),
         "angvel": rng.standard_normal((12, 3))}
    rhs = make_dem_rhs(cfg, neighbor="cell_lanes", cell_capacity=8,
                       device="cpu")
    assert rhs.neighbor_struct.cell_occupancy(y["pos"]) == 12
    out = rhs(0.0, to_torch(y))
    assert out["vel"].isnan().all() and out["angvel"].isnan().all()
    assert torch.equal(out["pos"], to_torch(y)["vel"])
    dropped = make_dem_rhs(cfg, neighbor="cell_list", cell_capacity=8,
                           device="cpu")(0.0, to_torch(y))
    assert torch.isfinite(dropped["vel"]).all()
    ok = make_dem_rhs(cfg, neighbor="cell_lanes", cell_capacity=16,
                      device="cpu")(0.0, to_torch(y))
    dense = make_dem_rhs(cfg, device="cpu")(0.0, to_torch(y))
    for k in ok:
        np.testing.assert_allclose(ok[k].numpy(), dense[k].numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


def test_settle_tracks_dense():
    """tests/test_dem_celllist.py's settle of 27 spheres to t = 0.5,
    cell_lanes at capacity 8 against dense."""
    cfg = DEMConfig(variant="friction_angular", n=27, r=0.1, T=0.5)
    y0, _ = icond_dense(cfg, seed=3)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min)
    out = {}
    for name in ("dense", "cell_lanes"):
        rhs = make_dem_rhs(cfg, neighbor=name, cell_capacity=8, device="cpu")
        st, status = merson_solve(rhs, merson_init(to_torch(y0), 0.0,
                                                   cfg.ht), 0.5, params)
        assert status == 0
        out[name] = st
    np.testing.assert_allclose(out["cell_lanes"].y["pos"].numpy(),
                               out["dense"].y["pos"].numpy(),
                               rtol=1e-6, atol=1e-8)
    assert abs(out["dense"].steps - out["cell_lanes"].steps) <= 1
    assert out["dense"].steps > 100


def test_large_n_smoke():
    """n = 2000 at r = 0.03 (tests/test_dem_celllist.py): finite, shaped."""
    cfg = DEMConfig(variant="friction_angular", n=2000, r=0.03)
    rng = np.random.RandomState(0)
    y = {"pos": rng.random_sample((2000, 3)) * np.array([1.0, 1.0, 2.0]),
         "vel": 0.1 * rng.standard_normal((2000, 3)),
         "angvel": 0.1 * rng.standard_normal((2000, 3))}
    out = make_dem_rhs(cfg, neighbor="cell_lanes", device="cpu")(
        0.0, to_torch(y))
    assert torch.isfinite(out["vel"]).all()
    assert torch.isfinite(out["angvel"]).all()
    assert out["pos"].shape == (2000, 3)


def test_f32_cells_match_dense():
    cfg = DEMConfig(variant="friction_angular", n=100, r=0.1)
    y = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
         for k, v in settled_like_state(cfg).items()}
    got = make_dem_rhs(cfg, dtype=torch.float32, neighbor="cell_lanes",
                       device="cpu")(0.0, y)
    want = make_dem_rhs(cfg, dtype=torch.float32, device="cpu")(0.0, y)
    for k in want:
        assert got[k].dtype == torch.float32
        w = want[k].double()
        assert float((got[k].double() - w).abs().max()) <= \
            1e-5 * float(w.abs().max()), k


def test_refusals():
    """cell_roll is not ported (its pairs are cell_list's; its layout was
    the superseded TPU variant) and names cell_lanes; the mesh path is
    dense-only, as in JAX."""
    from porousfreezethaw_tpu_torch.parallel import make_mesh
    cfg = DEMConfig(n=12)
    with pytest.raises(ValueError, match="cell_lanes"):
        make_dem_rhs(cfg, neighbor="cell_roll", device="cpu")
    with pytest.raises(ValueError, match="unknown neighbor"):
        make_dem_rhs(cfg, neighbor="cells", device="cpu")
    with pytest.raises(ValueError, match="dense neighbor"):
        make_dem_rhs(cfg, neighbor="cell_lanes",
                     mesh=make_mesh("p2", device="cpu"))
