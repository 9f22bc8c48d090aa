"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version at a small odd shape, the double-buffered attempt against
the fused_stage chain, short solves whose launch counters show that every
attempt went through the kernels, and the shard kernels (K1s, K3, K2s):
against their plain versions, and the mesh paths on virtual shards of the
card against the single-device paths bit for bit.

These tests need an NVIDIA GPU and nvcc; without them they skip.  The
machine with the card has no JAX, so run them without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config import parse_param_file
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing import physics
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    FreezingParams, shift_temperature_origin)
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from porousfreezethaw_tpu_torch.solvers.merson import (
    MersonParams, merson_init, merson_solve)

pytestmark = pytest.mark.cuda

SHAPE = (19, 23, 37)     # (n3, n2, n1): odd sizes catch edge indexing


@pytest.fixture(scope="module")
def dev():
    # decided here, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from porousfreezethaw_tpu_torch.ops.cuda import build
    try:
        build.find_nvcc()
    except build.KernelBuildError as exc:
        pytest.skip(str(exc))
    return torch.device("cuda:0")


def _params():
    """The benchmark case's parameters, shifted to u - u* (f32 runs)."""
    pf = parse_param_file(freezing_params_text(100, 0),
                          env={"OUTPUT": "unused"})
    prm = FreezingParams.from_dict(pf.vars)
    return shift_temperature_origin(prm, prm.u_star)


def _inputs(dev):
    rng = np.random.default_rng(3)
    w = np.stack([rng.uniform(-10, 10, SHAPE), rng.uniform(0, 1, SHAPE),
                  rng.uniform(0, 0.6, SHAPE)]).astype(np.float32)
    ks = [rng.standard_normal((2,) + SHAPE).astype(np.float32)
          for _ in range(3)]
    return (torch.from_numpy(w).to(dev), [torch.from_numpy(k).to(dev)
                                          for k in ks])


def _close(got, ref):
    """K/G and y_spec: rtol 1e-5, atol 1e-5 max|ref|; eps: 1e-3 relative
    + 1e-7 (the kernels contract multiply-adds, the plain versions do
    not)."""
    if isinstance(got, tuple):
        _close(got[0], ref[0])
        a, b = float(got[1].max()), float(ref[1].max())
        assert abs(a - b) <= 1e-3 * abs(b) + 1e-7, (a, b)
        return
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_kernels_match_plain(dev, mode):
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    spec = st.StencilSpec.of(geom, prm, mode)
    w, ks = _inputs(dev)
    h = 0.05
    for t in (prm.phase_switch_time - 0.5 * h, prm.phase_switch_time + 1.0):
        for cs, s5 in (([], False), ([1 / 3], False), ([0.5, 0.5], False),
                       ([0.1, 0.2, 0.3], False), ([0.5, -1.5, 2.0], True)):
            kk = list(zip(cs, ks))
            _close(st.fused_stage(spec, t, h, w, kk, stage5=s5),
                   st.fused_stage_plain(spec, t, h, w, kk, stage5=s5))
        D1 = physics.dirichlet_top(t, prm)
        dDi = float(np.float32(physics.dirichlet_top(t + h, prm) - D1))
        for cs, s5 in (([1 / 3], False), ([0.5, 0.5], False),
                       ([0.1, 0.2, 0.3], False), ([1.0, -1.5, 2.0], True)):
            kk = list(zip(cs, ks))
            _close(st.delta_g(spec, h, D1, dDi, w, kk, stage5=s5),
                   st.delta_g_plain(spec, h, D1, dDi, w, kk, stage5=s5))
        # K2': the emit="dy" tail
        kk = list(zip([1.0, -1.5, 2.0], ks))
        _close(st.delta_g(spec, h, D1, dDi, w, kk, stage5=True, emit="dy"),
               st.delta_g_plain(spec, h, D1, dDi, w, kk, stage5=True,
                                emit="dy"))
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_fused_attempt_matches_plain_and_stage_chain(dev, mode):
    """K4: one double-buffered attempt against the plain FusedAttempt
    (K and y_spec to the tolerance of _close) and, bit for bit, against
    the fused_stage kernel's stage-5 chain on the same state; accept and
    reject, and gl in both slots."""
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    spec = st.StencilSpec.of(geom, prm, mode)
    w, _ = _inputs(dev)
    t, h = 100.0, 0.05
    att, ref = st.FusedAttempt(geom, prm, mode), st.FusedAttempt(
        geom, prm, mode, plain=True)
    carry = att.pack(w)
    spec_k, eps = att.attempt(t, h, carry)
    carry_p = ref.pack(w)
    spec_p, eps_p = ref.attempt(t, h, carry_p)
    _close((carry[0][1, :2], eps), (carry_p[0][1, :2], eps_p))

    K1 = st.fused_stage(spec, t, h, w, [])
    K2 = st.fused_stage(spec, t + h / 3, h, w, [(1 / 3, K1)])
    K3 = st.fused_stage(spec, t + h / 3, h, w, [(1 / 6, K1), (1 / 6, K2)])
    K4 = st.fused_stage(spec, t + h / 2, h, w, [(1 / 8, K1), (3 / 8, K3)])
    y_spec, eps_ref = st.fused_stage(spec, t + h, h, w,
                                     [(0.5, K1), (-1.5, K3), (2.0, K4)],
                                     stage5=True)
    assert torch.equal(eps, eps_ref)
    assert torch.equal(att.unpack(att.commit(spec_k, False)), w)
    acc = att.unpack(att.commit(spec_k, True))
    assert torch.equal(acc[:2], y_spec) and torch.equal(acc[2], w[2])
    assert torch.equal(carry[0][0], w)           # the old slot is kept
    torch.cuda.synchronize()


def test_nan_reaches_the_controller(dev):
    """A NaN in the state gives a NaN eps (the block max propagates it)."""
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    spec = st.StencilSpec.of(geom, prm, 0)
    w, ks = _inputs(dev)
    w[1, 7, 11, 13] = float("nan")
    _, eps = st.delta_g(spec, 0.05, -25.0, 0.0, w,
                        [(1.0, ks[0]), (-1.5, ks[1]), (2.0, ks[2])],
                        stage5=True)
    assert torch.isnan(eps).any()


def test_solve_goes_through_both_kernels(dev):
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    w, _ = _inputs(dev)
    w[0] = torch.linspace(-5, 5, SHAPE[2], device=dev)
    att = st.DeltaAttempt(geom, prm, 0)
    st.fused_stage.launches = st.delta_g.launches = 0
    state, status = merson_solve(None, merson_init(w, 0.0, 1e-6), 1e9,
                                 MersonParams(delta=1e-3, max_steps=25,
                                              handle_nan=True),
                                 attempt_fn=att)
    assert state.steps_total == 25
    assert st.fused_stage.launches == 25
    assert st.delta_g.launches == 100
    assert torch.isfinite(state.y).all()


def test_solves_go_through_k2dy_and_k4(dev):
    """The compensated attempt launches K1, three K2 and one K2' per
    attempt; the double-buffered attempt five K4."""
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    w, _ = _inputs(dev)
    w[0] = torch.linspace(-5, 5, SHAPE[2], device=dev)
    params = MersonParams(delta=1e-3, max_steps=25, handle_nan=True)
    st.fused_stage.launches = st.delta_g.launches = 0
    st.delta_g.launches_dy = st.fused_attempt.launches = 0
    state, _ = merson_solve(None, merson_init(w, 0.0, 1e-6), 1e9, params,
                            attempt_fn=st.DeltaAttemptComp(geom, prm, 0))
    assert state.steps_total == 25 and state.y.shape[0] == 5
    assert (st.fused_stage.launches, st.delta_g.launches,
            st.delta_g.launches_dy) == (25, 75, 25)
    assert torch.isfinite(state.y).all()
    state, _ = merson_solve(None, merson_init(w, 0.0, 1e-6), 1e9, params,
                            attempt_fn=st.FusedAttempt(geom, prm, 0))
    assert state.steps_total == 25 and st.fused_attempt.launches == 125
    assert torch.isfinite(state.y).all()


# --------------------------------------------------------------------------
# the shard kernels (K1s, K3, K2s) and the mesh paths on virtual shards
# --------------------------------------------------------------------------

def _shard_inputs(w, ks, nk, lo, hi, rows):
    """One shard's planes [lo, hi) and rows ``rows`` of w and ks, and its
    ghost stacks from the planes around it (own edge planes at the ends)."""
    Z = w.shape[1]
    below, above = max(lo - 1, 0), min(hi, Z - 1)
    ws = w[:, lo:hi, rows].contiguous()
    kk = [K[:, lo:hi, rows].contiguous() for K in ks[:nk]]
    g = [torch.cat([w[:, p, rows]] + [K[:, p, rows] for K in ks[:nk]])
         .contiguous() for p in (below, above)]
    return ws, kk, g


@pytest.mark.parametrize("mode", [0, 2])
def test_shard_kernels_match_plain(dev, mode):
    """K1s (part all), K3 (interior + edge) and K2s (G, y_spec and dy) on
    one interior shard with a y window, against their plain versions
    (the tolerance of _close)."""
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    spec = st.StencilSpec.of(geom, prm, mode)
    w, ks = _inputs(dev)
    t, h = 100.0, 0.05
    rows, window = slice(4, 14), (1, 8, 5)      # own rows 5..12 of 23
    for nk, cs, s5 in ((0, [], False), (2, [0.5, 0.5], False),
                       (3, [0.5, -1.5, 2.0], True)):
        ws, kk, g = _shard_inputs(w, ks, nk, 6, 13, rows)
        kk = list(zip(cs, kk))
        ref = st.fused_stage_shard_plain(spec, t, h, ws, kk, g,
                                         window=window, stage5=s5)
        _close(st.fused_stage_shard(spec, t, h, ws, kk, g, window=window,
                                    stage5=s5), ref)
        prev = st.fused_stage_shard(spec, t, h, ws, kk, None,
                                    window=window, stage5=s5,
                                    part="interior")
        got = st.fused_stage_shard(spec, t, h, ws, kk, g, window=window,
                                   stage5=s5, part="edge",
                                   prev=prev if s5 else (prev,))
        _close(got, ref)
    for nk, cs, s5, emit in ((1, [1 / 3], False, "y"),
                             (3, [1.0, -1.5, 2.0], True, "y"),
                             (3, [1.0, -1.5, 2.0], True, "dy")):
        ws, kk, g = _shard_inputs(w, ks, nk, 12, 19, rows)   # the top
        kk = list(zip(cs, kk))
        for is_top in (True, False):
            args = (spec, h, -20.0, 1.5, ws, kk, g)
            kw = dict(is_top=is_top, window=window, stage5=s5, emit=emit)
            _close(st.delta_g_shard(*args, **kw),
                   st.delta_g_shard_plain(*args, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_mesh_paths_bitwise_on_virtual_shards(dev, mode):
    """Sharded equals single-device bit for bit on virtual shards of one
    card: the delta attempt at z1, z2, z4 (overlap on and off), z2,y2 and
    y2, the compensated attempt and the classic stage-5 tail; and the
    counters show the shard kernels ran."""
    from porousfreezethaw_tpu_torch.parallel import (
        gather_freezing_state, make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.fused import (
        ShardedDeltaAttempt, ShardedDeltaAttempt2D, make_sharded_fused_stage)
    prm = _params()
    shape = (20, 18, 37)
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    rng = np.random.default_rng(4)
    w = torch.from_numpy(np.stack([
        rng.uniform(-10, 10, shape), rng.uniform(0, 1, shape),
        rng.uniform(0, 0.6, shape)]).astype(np.float32)).to(dev)
    t, h = prm.phase_switch_time - 0.01, 0.05
    single = st.DeltaAttempt(geom, prm, mode)
    (_, ys_a), eps_a = single.attempt(t, h, single.pack(w))
    comp = st.DeltaAttemptComp(geom, prm, mode)
    (_, dy_a), epsc_a = comp.attempt(t, h, comp.pack(w))
    spec = st.StencilSpec.of(geom, prm, mode)
    ks = [torch.randn((2,) + shape, generator=torch.Generator().manual_seed(q)
                      ).to(dev) for q in range(3)]
    combo = list(zip([0.5, -1.5, 2.0], ks))
    yc_a, ec_a = st.fused_stage(spec, t, h, w, combo, stage5=True)
    counts = [st.fused_stage_shard.launches,
              st.fused_stage_shard.launches_split,
              st.delta_g_shard.launches, st.delta_g_shard.launches_dy]
    for ms, n in (("z1", 1), ("z2", 2), ("z4", 4), ("z2,y2", 4), ("y2", 2)):
        mesh = make_mesh(ms, [dev] * n)
        shards = shard_freezing_state(w, mesh)
        for overlap in ((True, False) if "y" not in ms else (False,)):
            for _ in range(3):          # stream-ordering faults are rare
                if "y" in ms:
                    att = ShardedDeltaAttempt2D(geom, prm, mode, mesh)
                else:
                    att = ShardedDeltaAttempt(geom, prm, mode, mesh,
                                              overlap=overlap)
                (_, ys_b), eps_b = att.attempt(t, h, att.pack(shards))
                assert torch.equal(gather_freezing_state(ys_b, mesh), ys_a)
                assert torch.equal(eps_b.max(), eps_a.max())
            if "y" in ms:
                continue
            attc = ShardedDeltaAttempt(geom, prm, mode, mesh,
                                       overlap=overlap, compensated=True)
            (_, dy_b), epsc_b = attc.attempt(t, h, attc.pack(shards))
            assert torch.equal(gather_freezing_state(dy_b, mesh), dy_a)
            assert torch.equal(epsc_b.max(), epsc_a.max())
            stage = make_sharded_fused_stage(geom, prm, mode, mesh,
                                             overlap=overlap)
            ys, e = stage.stage5(t, h, shards, [
                (c, shard_freezing_state(k, mesh)) for c, k in combo])
            assert torch.equal(gather_freezing_state(ys, mesh), yc_a)
            assert torch.equal(e.max(), ec_a.max())
    torch.cuda.synchronize()
    after = [st.fused_stage_shard.launches,
             st.fused_stage_shard.launches_split,
             st.delta_g_shard.launches, st.delta_g_shard.launches_dy]
    assert all(b > a for a, b in zip(counts, after))
