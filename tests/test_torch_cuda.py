"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version at a small odd shape, the double-buffered attempt against
the fused_stage chain, short solves whose launch counters show that every
attempt went through the kernels, the device-resident loop against the
host loop bit for bit (the freezing paths, the plain right-hand side's
in f32 with a noise field, and the DEM's, with the control and commit
kernels in float64 and float32); the float64 stage kernel against its
plain version at MR and at odd, unaligned shapes, and the f64 path on it
(PlainAttempt's stage-kernel route) against the host loop over make_rhs
with equal counts, to the kernel's rounding; and the shard kernels (K1s,
K3, K2s):
against their plain versions, and the mesh paths on virtual shards of the
card against the single-device paths bit for bit; the shard kernels' _dev
entries against their by-value entries bit for bit, and the device loop
on a z4 mesh of virtual shards against its host loop at MR.

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
    MersonParams, merson_init, merson_solve, merson_solve_device)

pytestmark = pytest.mark.cuda

SHAPE = (19, 23, 37)     # (n3, n2, n1): odd sizes catch edge indexing
# shapes at the edges of the tiles of the stage and delta kernels
# (csrc/tile.cuh: 50 x 10 points, a chunk of planes chosen at launch): x and
# y smaller than a tile and z than any chunk; x and y one or more past a
# multiple of the tile; rows that allow 4-byte copies only (odd x), 8-byte
# (x = 26) and 16-byte (x = 52); and 20 tiles of 37 planes, whose grid on
# the card takes chunks of several planes with a shorter last chunk
EDGE_SHAPES = ((2, 3, 7), (13, 17, 51), (5, 11, 33), (6, 13, 52),
               (9, 21, 26), (37, 100, 100))


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


def _inputs(dev, shape=SHAPE):
    rng = np.random.default_rng(3)
    w = np.stack([rng.uniform(-10, 10, shape), rng.uniform(0, 1, shape),
                  rng.uniform(0, 0.6, shape)]).astype(np.float32)
    ks = [rng.standard_normal((2,) + shape).astype(np.float32)
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
    """Every kernel against its plain version at the odd shape and at the
    edges of the tiles of the stage and delta kernels."""
    prm = _params()
    for shape in (SHAPE,) + EDGE_SHAPES:
        _kernels_match_plain(dev, prm, mode, shape)
    torch.cuda.synchronize()


def _kernels_match_plain(dev, prm, mode, shape):
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    spec = st.StencilSpec.of(geom, prm, mode)
    w, ks = _inputs(dev, shape)
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


@pytest.mark.parametrize("fn", ["pft_delta_g", "pft_delta_g_shard"])
def test_delta_tail_refuses_a_short_eps_buffer(dev, fn):
    """The delta entries launch a tail only when the eps buffer has a slot
    for every block of its grid."""
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    spec = st.StencilSpec.of(geom, prm, 0)
    w, ks = _inputs(dev)
    kk = [(1.0, ks[0]), (-1.5, ks[1]), (2.0, ks[2])]
    n = st._eps_blocks("pft_delta_eps_blocks", dev, 0, 1, *SHAPE)
    out = torch.empty((2,) + SHAPE, dtype=torch.float32, device=dev)
    ghost = torch.zeros((9,) + SHAPE[1:], dtype=torch.float32, device=dev)
    shard = (() if fn == "pft_delta_g" else
             (ghost.data_ptr(), ghost.data_ptr(), 1, 0, SHAPE[1], 0,
              SHAPE[1]))
    for slots, ok in ((n, True), (n - 1, False)):
        eps = torch.empty((slots,), dtype=torch.float32, device=dev)
        call = lambda: st._kernel_call(  # noqa: E731
            fn, spec, (0.05, -25.0, 0.0), (w.data_ptr(),), dev, kk, 1, out,
            eps=eps, extra=shard)
        if ok:
            call()
        else:
            with pytest.raises(st.KernelLaunchError, match="invalid"):
                call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("fn", ["pft_fused_stage", "pft_fused_stage_shard",
                                "pft_fused_attempt"])
def test_stage_tail_refuses_a_short_eps_buffer(dev, fn):
    """The stage entries (K1, K1s/K3 in each part, K4) launch a tail only
    when the eps buffer has a slot for every block of its grid."""
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    spec = st.StencilSpec.of(geom, prm, 0)
    w, ks = _inputs(dev)
    kk = [(0.5, ks[0]), (-1.5, ks[1]), (2.0, ks[2])]
    out = torch.empty((2,) + SHAPE, dtype=torch.float32, device=dev)
    ghost = torch.zeros((9,) + SHAPE[1:], dtype=torch.float32, device=dev)
    if fn == "pft_fused_attempt":
        y2 = torch.stack([w, w])
        cur = torch.zeros(1, dtype=torch.int32, device=dev)
        cases = [((y2.data_ptr(), cur.data_ptr()), (),
                  st._eps_blocks("pft_attempt_eps_blocks", dev, 0, *SHAPE))]
    else:
        cases = [((w.data_ptr(),),
                  () if fn == "pft_fused_stage" else
                  (ghost.data_ptr(), ghost.data_ptr(), part, 0, SHAPE[1], 0,
                   SHAPE[1]),
                  st._eps_blocks("pft_stage_eps_blocks", dev, 0, part,
                                 *SHAPE))
                 for part in ((0,) if fn == "pft_fused_stage"
                              else (0, 1, 2))]
    for ptrs, shard, n in cases:
        for slots, ok in ((n, True), (n - 1, False)):
            eps = torch.empty((slots,), dtype=torch.float32, device=dev)
            call = lambda: st._kernel_call(  # noqa: E731
                fn, spec, (100.0, 0.05), ptrs, dev, kk, 1, out, eps=eps,
                extra=shard)
            if ok:
                call()
            else:
                with pytest.raises(st.KernelLaunchError, match="invalid"):
                    call()
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("path", ["delta", "delta_comp", "fused_attempt",
                                  "stage"])
def test_device_loop_equals_host_loop(dev, path):
    """merson_solve_device (CUDA graphs of attempts, the control and
    commit kernels) against merson_solve on the card: 3 chunks of 25
    attempts with a trace, bit for bit; the launch counters count every
    launch of the graphs' replays (whole blocks of BLOCK attempts), and
    the control and commit once per attempt, plus the idle attempt before
    the capture."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    w, _ = _inputs(dev)
    w[0] = torch.linspace(-5, 5, SHAPE[2], device=dev)
    params = MersonParams(delta=1e-3, max_steps=25, record_trace=25,
                          handle_nan=True,
                          accept_growth_min=1.05 if path == "stage" else 0.0)
    if path == "stage":
        stage_fn = st.make_fused_stage(geom, prm, 0)
        att = st.StageAttempt(geom, prm, 0)

        def host(s):
            return merson_solve(None, s, 1e9, params, stage_fn=stage_fn)
    else:
        cls = {"delta": st.DeltaAttempt, "delta_comp": st.DeltaAttemptComp,
               "fused_attempt": st.FusedAttempt}[path]
        host_att, att = cls(geom, prm, 0), cls(geom, prm, 0)

        def host(s):
            return merson_solve(None, s, 1e9, params, attempt_fn=host_att)
    sa = sb = merson_init(w, 0.0, 1e-6)
    for call in range(3):
        a = host(sa)
        control.merson_control.launches = control.commit.launches = 0
        b = merson_solve_device(sb, 1e9, params, att)
        n = b[0].steps_total - sb.steps_total
        assert n == 25
        assert control.merson_control.launches == control.commit.launches
        blocks = -(-n // control.BLOCK)
        assert control.commit.launches == (control.BLOCK * blocks
                                           + (call == 0))
        assert a[1] == b[1]
        assert (a[0].t, a[0].h, a[0].steps, a[0].steps_total) == (
            b[0].t, b[0].h, b[0].steps, b[0].steps_total)
        assert torch.equal(a[0].y, b[0].y)
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
        sa, sb = a[0], b[0]
    assert torch.isfinite(sb.y).all()


# --------------------------------------------------------------------------
# the control and commit kernels in float64, and the DEM's device loop
# --------------------------------------------------------------------------

def _control_f64_cases():
    """(name, fields, float64 partials) of the control kernel's float64
    reduction: below and above delta, a value below delta that float32
    rounds to it, 0, NaN and inf with and without the backoff."""
    rng = np.random.default_rng(7)
    below = np.nextafter(1e-3, 0.0)

    def parts(peak):
        p = rng.uniform(0.0, 1e-4, 37)
        if peak == 0.0:
            p[:] = 0.0
        p[rng.integers(37)] = peak
        return p

    return [("below", {}, parts(2e-4)), ("above", {}, parts(5e-3)),
            ("rounds_to_delta", {}, parts(below)), ("zero", {}, parts(0.0)),
            ("nan", {}, parts(np.nan)), ("inf", {}, parts(np.inf)),
            ("nan_backoff", {"handle_nan": 1}, parts(np.nan)),
            ("inf_backoff", {"handle_nan": 1}, parts(np.inf))]


def test_control_f64_partials_match_plain(dev):
    """pft_merson_control on float64 partials against control_plain, the
    whole block but its pointers bit for bit (hs included)."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    n0 = control.merson_control.launches_f64
    for name, fields, parts in _control_f64_cases():
        out = {}
        for where in ("kernel", "plain"):
            d = dev if where == "kernel" else torch.device("cpu")
            eps = torch.from_numpy(parts).to(d)
            block = control.ControlBlock(d, eps)
            c = control.Control(t=1.0, h=0.01, h_cont=0.01, tf=1e9,
                                delta=1e-3, max_steps=2**62,
                                eps=eps.data_ptr(), eps_n=eps.numel(),
                                eps_f64=1, **fields)
            control.next_scalars_plain(c)
            block.write(c)
            control.merson_control(block)
            r = block.read()
            r.eps = None
            out[where] = bytes(r)
        assert out["kernel"] == out["plain"], name
    assert control.merson_control.launches_f64 == n0 + 8


@pytest.mark.parametrize("n", [1801, 1800])
def test_commit_f64_copy_matches_plain(dev, n):
    """pft_commit's copy of float64 planes (n words odd and a multiple of
    4) against commit_plain, accept 0 and 1, bit for bit."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    rng = np.random.default_rng(8)
    hi0 = torch.from_numpy(rng.standard_normal(n)).to(dev)
    src = torch.from_numpy(rng.standard_normal(n)).to(dev)
    n0 = control.commit.launches_f64
    for accept in (0, 1):
        got = {}
        for where in ("kernel", "plain"):
            d = dev if where == "kernel" else torch.device("cpu")
            block = control.ControlBlock(d, torch.zeros(1, device=d))
            block.write(control.Control(accept=accept))
            hi = hi0.clone()
            control.commit(block, control.COMMIT_COPY, hi, src=src)
            got[where] = hi
        torch.cuda.synchronize()
        assert torch.equal(got["kernel"], got["plain"])
        assert torch.equal(got["kernel"], src if accept else hi0)
    assert control.commit.launches_f64 == n0 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scalar_views_round_as_python_floats_on_the_card(dev, dtype):
    """x * a with a a 0-d float64 view of a control block in device memory
    equals x * a with the Python float on the card."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        100_000)).to(dev, dtype)
    block = control.ControlBlock(dev, torch.zeros(1, device=dev))
    for h in (0.1, 1 / 3, 2.7182818284590455e-05, 0.0123456789):
        c = control.Control(h=h)
        control.next_scalars_plain(c)
        block.write(c)
        for a, view in zip((h / 3, h / 6, h / 8, h), block.hs):
            got = x * view
            assert got.dtype == dtype and torch.equal(got, x * a)


@pytest.mark.parametrize("neighbor", ["dense", "cell_lanes"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dem_device_loop_equals_host_loop(dev, dtype, neighbor):
    """DEMAttempt through merson_solve_device (CUDA graphs of attempts,
    the control and commit kernels in the state's width) against
    merson_solve on the card: 40 spheres of the dense bed in 3 calls of
    at most 60 attempts, bit for bit; the control and commit launches
    count whole blocks and the idle attempt before the capture."""
    from porousfreezethaw_tpu_torch.models.dem import (
        DEMAttempt, DEMConfig, icond_dense, make_dem_rhs)
    from porousfreezethaw_tpu_torch.ops.cuda import control
    cfg = DEMConfig(variant="friction_angular", n=40)
    y0, _ = icond_dense(cfg, seed=0)
    y = {k: torch.as_tensor(v, dtype=dtype, device=dev)
         for k, v in y0.items()}
    rhs = make_dem_rhs(cfg, dtype=dtype, neighbor=neighbor, device=dev)
    att = DEMAttempt(rhs)
    params = MersonParams(delta=cfg.delta, h_min=cfg.ht_min, max_steps=60,
                          handle_nan=dtype == torch.float32)
    wide = dtype == torch.float64
    name = "launches_f64" if wide else "launches"
    sa = sb = merson_init(y, 0.0, cfg.ht)
    for call in range(3):
        a = merson_solve(rhs, sa, 0.6, params)
        before = getattr(control.commit, name)
        b = merson_solve_device(sb, 0.6, params, att)
        n = b[0].steps_total - sb.steps_total
        blocks = -(-n // control.BLOCK)
        assert getattr(control.commit, name) - before == (
            control.BLOCK * blocks + (call == 0))
        assert a[1] == b[1]
        assert (a[0].t, a[0].h, a[0].steps, a[0].steps_total) == (
            b[0].t, b[0].h, b[0].steps, b[0].steps_total)
        assert all(torch.equal(a[0].y[k], b[0].y[k]) for k in a[0].y)
        sa, sb = a[0], b[0]
    assert sb.steps > 60 and sb.t > 0.0
    assert att.device_loop(dev).capture_s > 0.0


# --------------------------------------------------------------------------
# the plain-RHS freezing solve on the device loop (f64, f32 with noise)
# --------------------------------------------------------------------------

def test_stage_times_of_the_control_kernel(dev):
    """The control kernel's float64 stage times (ts64) after a step equal
    control_plain's, over random (t, h): the host loop's Python floats."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    rng = np.random.default_rng(10)
    for t, h in zip((10.0 ** rng.uniform(-6, 5, 200)).tolist(),
                    (10.0 ** rng.uniform(-9, 2, 200)).tolist()):
        got = {}
        for where in ("kernel", "plain"):
            d = dev if where == "kernel" else torch.device("cpu")
            eps = torch.zeros(1, dtype=torch.float64, device=d)
            block = control.ControlBlock(d, eps)
            c = control.Control(t=t, h=h, h_cont=h, tf=1e12, delta=1e-3,
                                max_steps=2**62, eps=eps.data_ptr(),
                                eps_n=1, eps_f64=1)
            control.next_scalars_plain(c)
            block.write(c)
            control.merson_control(block)
            got[where] = [float(v) for v in block.ts64]
        c = block.read()
        assert got["kernel"] == got["plain"] == [
            c.t, c.t + c.h / 3, c.t + c.h / 2, c.t + c.h]


def _f64_params():
    """The benchmark case's parameters, u absolute (f64 runs)."""
    pf = parse_param_file(freezing_params_text(100, 0),
                          env={"OUTPUT": "unused"})
    return FreezingParams.from_dict(pf.vars)


def _plain_case(dev, name):
    """(rhs, state, MersonParams keywords, params) at SHAPE on dev:
    'f64_<mode>' (the benchmark case's parameters) or 'noise_f32' (GradP,
    u stored as u - u*, a noise field of amplitude 0.5)."""
    from porousfreezethaw_tpu_torch.models.freezing.equation import (
        make_noise_field, make_rhs)
    prm = _f64_params()
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    rng = np.random.default_rng(4)
    w = np.stack([6.0 * (rng.random(SHAPE) - 0.5), rng.random(SHAPE),
                  0.6 * rng.random(SHAPE)])
    if name == "noise_f32":
        prm = shift_temperature_origin(prm, prm.u_star)
        noise = 0.5 * (rng.random(SHAPE) - 0.5)
        return (make_rhs(geom, prm, 0, dev, noise=noise.astype(np.float32)),
                torch.from_numpy(w.astype(np.float32)).to(dev),
                dict(handle_nan=True, accept_growth_min=1.05), prm)
    w[0] += prm.u_star
    return (make_rhs(geom, prm, int(name.split("_")[1]), dev),
            torch.from_numpy(w).to(dev), {}, prm)


@pytest.mark.parametrize("name", ["f64_0", "f64_1", "f64_2", "f64_10",
                                  "f64_11", "noise_f32"])
def test_plain_device_loop_equals_host_loop(dev, name):
    """PlainAttempt through merson_solve_device against merson_solve, from
    0.01 s below the Dirichlet switch across it, in 4 calls of 25 attempts
    with a trace; the control and commit launches count whole blocks and
    the idle attempt before the capture.  f32 with noise (CUDA graphs of
    attempts of the plain right-hand side, its stage times read from the
    control block) against the host loop on the card: bit for bit.  f64
    (the stage-kernel route: the float64 fused_stage kernel, 5 launches an
    attempt, and the control and commit kernels in float64) against the
    host loop over make_rhs whose PyTorch kernels round the model's
    operations as the kernel does, each on its own: on the card for Temp,
    on the CPU for the phase-field models, where PyTorch's CUDA kernels
    divide by the scalar alpha as a product with its reciprocal (and the
    CPU's exp, Temp's, is not correctly rounded).  On this rough state the
    error estimate sits near its rounding floor (h about 1e-6), where an
    ulp moves h by up to 1%; against those host loops: equal counts and
    statuses, t, h and the trace within 1e-10 and the state within 1e-10
    of max|ref| (Temp bit for bit)."""
    from porousfreezethaw_tpu_torch.models.freezing.attempt import (
        PLAIN_RHS, STAGE_KERNEL, PlainAttempt)
    from porousfreezethaw_tpu_torch.models.freezing.equation import (
        dirichlet_at, make_rhs)
    from porousfreezethaw_tpu_torch.ops.cuda import control
    rhs, y0, kw, prm = _plain_case(dev, name)
    att = PlainAttempt(rhs, SHAPE, y0.dtype)
    wide = y0.dtype == torch.float64
    assert att.route == (STAGE_KERNEL if wide else PLAIN_RHS)
    on_cpu = wide and name != "f64_2"
    host_rhs = make_rhs(*rhs.built[:3], "cpu") if on_cpu else rhs
    params = MersonParams(delta=1e-3, h_min=1e-6, max_steps=25,
                          record_trace=25, **kw)
    counter = "launches_f64" if wide else "launches"
    t0 = prm.phase_switch_time - 1e-2
    sa = merson_init(y0.cpu() if on_cpu else y0, t0, 1e-6)
    sb = merson_init(y0, t0, 1e-6)
    for call in range(4):
        a = merson_solve(host_rhs, sa, t0 + 1.0, params)
        before = getattr(control.commit, counter)
        stages = st.fused_stage.launches
        b = merson_solve_device(sb, t0 + 1.0, params, att)
        n = b[0].steps_total - sb.steps_total
        blocks = -(-n // control.BLOCK)
        launched = control.BLOCK * blocks + (call == 0)
        assert getattr(control.commit, counter) - before == launched
        assert st.fused_stage.launches - stages == 5 * launched * wide
        assert a[1] == b[1]
        assert (a[0].steps, a[0].steps_total) == (b[0].steps,
                                                  b[0].steps_total)
        if wide:
            assert b[0].t == pytest.approx(a[0].t, rel=1e-10)
            assert b[0].h == pytest.approx(a[0].h, rel=1e-10)
            for x, y in zip(a[2], b[2]):
                torch.testing.assert_close(y, x, rtol=1e-10, atol=0.0)
            torch.testing.assert_close(
                b[0].y.to(a[0].y.device), a[0].y, rtol=0.0,
                atol=1e-10 * float(a[0].y.abs().max()))
        else:
            assert (a[0].t, a[0].h) == (b[0].t, b[0].h)
            assert torch.equal(a[0].y, b[0].y)
            assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
        sa, sb = a[0], b[0]
    assert dirichlet_at(sb.t, prm, y0.dtype) == dirichlet_at(
        prm.phase_switch_time, prm, y0.dtype)
    assert torch.isfinite(sb.y).all()
    assert att.device_loop(dev).capture_s > 0.0


# --------------------------------------------------------------------------
# the float64 stage kernel (fused_stage_dev64) and the f64 path on it
# --------------------------------------------------------------------------

# MR, and shapes whose rows allow 8-byte copies only (odd x), 16-byte ones
# (x = 26), a grid smaller than a tile and one of 20 tiles of 37 planes
STAGE64_SHAPES = ((200, 100, 100), SHAPE, (9, 21, 26), (2, 3, 7),
                  (37, 100, 100))


def _inputs64(dev, shape, prm):
    rng = np.random.default_rng(13)
    w = np.stack([prm.u_star + rng.uniform(-10, 10, shape),
                  rng.uniform(0, 1, shape), rng.uniform(0, 0.6, shape)])
    ks = [rng.standard_normal((2,) + shape) for _ in range(3)]
    return (torch.from_numpy(w).to(dev),
            [torch.from_numpy(k).to(dev) for k in ks])


def _block64(dev, t, h, eps, **fields):
    """A control block on dev at (t, h) with its next attempt's scalars."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    block = control.ControlBlock(dev, eps)
    c = control.Control(t=t, h=h, h_cont=h, tf=1e12, delta=1e-3,
                        max_steps=2**62, eps=eps.data_ptr(),
                        eps_n=eps.numel(), eps_f64=1, **fields)
    control.next_scalars_plain(c)
    block.write(c)
    return block, c


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_stage64_kernel_matches_plain(dev, mode):
    """Each of the five stages of the float64 _dev entry (stage 5 with and
    without its tail) against the float64 plain version on the block's
    stage time and scale, at MR and at odd, unaligned shapes, on each side
    of the Dirichlet switch: K and y_spec within 1e-13 of max|ref|, the
    eps partials' max within 1e-12 of the plain eps; every launch counted
    under fused_stage.launches, and a halted block's launch writes
    nothing."""
    prm = _f64_params()
    h = 0.05
    for shape in STAGE64_SHAPES:
        geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
        spec = st.StencilSpec.of(geom, prm, mode, torch.float64)
        w, ks = _inputs64(dev, shape, prm)
        n_eps = st._eps_blocks("pft_stage_eps_blocks64", dev, mode, *shape)
        eps = torch.empty(n_eps, dtype=torch.float64, device=dev)
        for t in (prm.phase_switch_time - 0.4 * h,
                  prm.phase_switch_time + 1.0):
            block, c = _block64(dev, t, h, eps)
            for stage, tail in ((0, False), (1, False), (2, False),
                                (3, False), (4, False), (4, True)):
                kk = list(zip(st.STAGE_COEFS[torch.float64][stage], ks))
                out = torch.full((2,) + shape, float("nan"),
                                 dtype=torch.float64, device=dev)
                before = st.fused_stage.launches
                st.fused_stage_dev(spec, block, stage, w, kk, out,
                                   stage5=tail, eps=eps if tail else None)
                assert st.fused_stage.launches == before + 1
                ref = st.fused_stage_plain(
                    spec, c.ts64[st.STAGE64_TIME[stage]],
                    c.hs[st.STAGE64_SCALE[stage]], w, kk, stage5=tail)
                want = ref[0] if tail else ref
                torch.testing.assert_close(
                    out, want, rtol=0.0,
                    atol=1e-13 * float(want.abs().max()))
                if tail:
                    a, b = float(eps.max()), float(ref[1][0])
                    assert abs(a - b) <= 1e-12 * b, (a, b)
        halted, _ = _block64(dev, 100.0, h, eps, halt=1)
        out = torch.full((2,) + shape, float("nan"), dtype=torch.float64,
                         device=dev)
        st.fused_stage_dev(spec, halted, 0, w, [], out)
        assert bool(torch.isnan(out).all())
    torch.cuda.synchronize()


# (calc mode, chunks of 12 attempts): the windows of
# tests/test_torch_freezing_device.py test_f64_counts_equal_jax
F64_WINDOWS = ((0, 3), (1, 3), (2, 1), (10, 3), (11, 3))


@pytest.mark.parametrize("mode,chunks", F64_WINDOWS,
                         ids=[str(m) for m, _ in F64_WINDOWS])
def test_f64_windows_on_the_stage_kernel(dev, mode, chunks):
    """test_f64_counts_equal_jax's windows on the card: the f64 path's
    device loop (PlainAttempt on the float64 stage kernel) against the
    host loop over make_rhs on the CPU (the loop that test holds to JAX)
    from the same smooth state at h0 = 0.3, in chunks of 12 attempts with
    a trace (each after a MAX_STEPS exit), held as that test holds it:
    equal counts and statuses chunk by chunk, the state within 1e-12 of
    max|ref|, t, h and the traces within 1e-6 (T_RTOL, H_RTOL of
    tests/test_torch_merson.py; the host's sqrt and exp are an ulp from
    the kernel's correctly rounded ones here and there)."""
    from porousfreezethaw_tpu_torch.models.freezing.attempt import (
        STAGE_KERNEL, PlainAttempt)
    from porousfreezethaw_tpu_torch.models.freezing.equation import (
        make_rhs)
    prm = _f64_params()
    shape = (16, 8, 8)
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    z, y, x = np.meshgrid(*(np.linspace(0, 1, n) for n in shape),
                          indexing="ij")
    w = np.stack([
        prm.u_star - 4.0 + 6.0 * z + 0.5 * np.sin(3 * x + 2 * y),
        0.5 + 0.45 * np.tanh(4 * (0.5 - z) + np.cos(5 * x) * np.sin(4 * y)),
        0.3 * np.exp(-8 * ((x - 0.5) ** 2 + (y - 0.4) ** 2
                           + (z - 0.5) ** 2))])
    att = PlainAttempt(make_rhs(geom, prm, mode, dev), shape, torch.float64)
    assert att.route == STAGE_KERNEL
    host_rhs = make_rhs(geom, prm, mode, "cpu")
    params = MersonParams(delta=1e-3, h_min=1e-9, max_steps=12,
                          record_trace=12)
    sa = merson_init(torch.from_numpy(w), 0.0, 0.3)
    sb = merson_init(torch.from_numpy(w).to(dev), 0.0, 0.3)
    for _ in range(chunks):
        a = merson_solve(host_rhs, sa, 1e9, params)
        b = merson_solve_device(sb, 1e9, params, att)
        assert a[1] == b[1]
        assert (a[0].steps, a[0].steps_total) == (b[0].steps,
                                                  b[0].steps_total)
        assert b[0].t == pytest.approx(a[0].t, rel=1e-6)
        assert b[0].h == pytest.approx(a[0].h, rel=1e-6)
        for p, q in zip(a[2], b[2]):
            torch.testing.assert_close(q, p, rtol=1e-6, atol=0.0)
        torch.testing.assert_close(b[0].y.cpu(), a[0].y, rtol=0.0,
                                   atol=1e-12 * float(a[0].y.abs().max()))
        sa, sb = a[0], b[0]
    assert sb.steps >= 9


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


# shards of SHAPE: (planes [lo, hi), input rows, window (r0, Yl, y0)).  An
# interior shard with own rows 5..12; the top shard with them; the top with
# one own row; the bottom two planes (fewer than a chunk) with one own row
# at the y chain start; 14 planes with the 12 own rows of the y chain end;
# a z4 shard (5 planes) of one own row; a shard of 3 planes, whose interior
# pass is one plane; 13 own rows at the y chain end (a tile and 3 rows)
SHARDS = ((6, 13, slice(4, 14), (1, 8, 5)), (12, 19, slice(4, 14), (1, 8, 5)),
          (12, 19, slice(4, 7), (1, 1, 5)), (0, 2, slice(0, 2), (0, 1, 0)),
          (3, 17, slice(10, None), (1, 12, 11)),
          (5, 10, slice(10, 13), (1, 1, 11)),
          (8, 11, slice(4, 14), (1, 8, 5)),
          (2, 16, slice(9, None), (1, 13, 10)))


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_shard_kernels_match_plain(dev, mode):
    """K1s (part all), K3 (interior + edge) and K2s (G, y_spec and dy, with
    and without the Dirichlet top) on the shards of SHARDS, of SHAPE and of
    the same grid 52 wide (16-byte rows), against their plain versions (the
    tolerance of _close)."""
    prm = _params()
    for shape in (SHAPE, SHAPE[:2] + (52,)):
        _shard_kernels_match_plain(dev, prm, mode, shape)
    torch.cuda.synchronize()


def _shard_kernels_match_plain(dev, prm, mode, shape):
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    spec = st.StencilSpec.of(geom, prm, mode)
    w, ks = _inputs(dev, shape)
    t, h = 100.0, 0.05
    for lo, hi, rows, window in SHARDS:
        for nk, cs, s5 in ((0, [], False), (2, [0.5, 0.5], False),
                           (3, [0.5, -1.5, 2.0], True)):
            ws, kk, g = _shard_inputs(w, ks, nk, lo, hi, rows)
            kk = list(zip(cs, kk))
            ref = st.fused_stage_shard_plain(spec, t, h, ws, kk, g,
                                             window=window, stage5=s5)
            _close(st.fused_stage_shard(spec, t, h, ws, kk, g,
                                        window=window, stage5=s5), ref)
            if hi - lo < 3:
                continue                # the split needs three planes
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
            ws, kk, g = _shard_inputs(w, ks, nk, lo, hi, rows)
            kk = list(zip(cs, kk))
            for is_top in (True, False):
                args = (spec, h, -20.0, 1.5, ws, kk, g)
                kw = dict(is_top=is_top, window=window, stage5=s5, emit=emit)
                _close(st.delta_g_shard(*args, **kw),
                       st.delta_g_shard_plain(*args, **kw))


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


# --------------------------------------------------------------------------
# the shard kernels' _dev entries and the device loop on a mesh
# --------------------------------------------------------------------------

# (stage, coefficients, stage5) of the classic stage's five stages and of
# the delta kernel's stages 2-5
CLASSIC_STAGES = ((0, (), False), (1, (1 / 3,), False),
                  (2, (1 / 6, 1 / 6), False), (3, (1 / 8, 3 / 8), False),
                  (4, (0.5, -1.5, 2.0), True))
DELTA_STAGES = ((1, (1 / 3,), False), (2, (1 / 3, 1 / 6), False),
                (3, (0.5, 0.375), False), (4, (1.0, -1.5, 2.0), True))


def _control_block(dev, prm, **fields):
    """A control block on dev at the given fields, with the next attempt's
    scalars formed (the Dirichlet top of prm)."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    c = control.Control(tf=1e9, delta=1e-3, max_steps=2**62,
                        top1=prm.top_temp1, top2=prm.top_temp2,
                        t_switch=prm.phase_switch_time)
    for k, v in fields.items():
        setattr(c, k, v)
    control.next_scalars_plain(c)
    block = control.ControlBlock(dev, torch.zeros(1, device=dev))
    block.write(c)
    return c, block


def _slots(dev, fn, *args):
    return st._eps_blocks(fn, dev, *args)


def _shard_dev_pairs(dev, spec, c, block, w, ks, lo, hi, rows, window):
    """(by-value result, _dev result) of every stage of both kernels on
    one shard, the _dev scalars from ``block`` and the by-value entries
    given the same values; the classic stage on the top shard with the
    Dirichlet top in its ghost stack (by value) or decided by the kernel
    (is_top)."""
    top = hi == w.shape[1]
    mode = int(spec.mode)
    zl, X = hi - lo, w.shape[3]
    Yl = window[1]
    pairs = []
    for q, cs, s5 in CLASSIC_STAGES:
        ws, kk, g = _shard_inputs(w, ks, len(cs), lo, hi, rows)
        kk = list(zip(cs, kk))
        gd = st._dirichlet_ghost(spec, c.ts[q], g, len(cs)) if top else g
        args = (spec, c.ts[q], c.h32, ws, kk)
        ref = st.fused_stage_shard(*args, gd, window=window, stage5=s5)
        out = torch.empty((2, zl, Yl, X), device=dev)
        eps = torch.empty(_slots(dev, "pft_stage_eps_blocks", mode, 0, zl,
                                 Yl, X), device=dev)
        st.fused_stage_shard_dev(spec, block, q, ws, kk, g, out, is_top=top,
                                 window=window, stage5=s5,
                                 eps=eps if s5 else None)
        pairs.append((ref, (out, eps) if s5 else out))
        if zl < 3:
            continue                    # the split needs three planes
        prev = st.fused_stage_shard(*args, None, window=window, stage5=s5,
                                    part="interior")
        ref = st.fused_stage_shard(*args, gd, window=window, stage5=s5,
                                   part="edge", prev=prev if s5 else (prev,))
        n_int = _slots(dev, "pft_stage_eps_blocks", mode, 1, zl, Yl, X)
        eps = torch.empty(n_int + _slots(dev, "pft_stage_eps_blocks", mode,
                                         2, zl, Yl, X), device=dev)
        out = torch.empty((2, zl, Yl, X), device=dev)
        for part, g_, e in (("interior", None, eps[:n_int]),
                            ("edge", g, eps[n_int:])):
            st.fused_stage_shard_dev(spec, block, q, ws, kk, g_, out,
                                     is_top=top, window=window, stage5=s5,
                                     part=part, eps=e if s5 else None)
        pairs.append((ref, (out, eps) if s5 else out))
    for q, cs, s5 in DELTA_STAGES:
        ws, kk, g = _shard_inputs(w, ks, len(cs), lo, hi, rows)
        kk = list(zip(cs, kk))
        for emit in (("y", "dy") if s5 else ("y",)):
            kw = dict(is_top=top, window=window, stage5=s5, emit=emit)
            ref = st.delta_g_shard(spec, c.h32, c.D1, c.dD[q], ws, kk, g,
                                   **kw)
            out = torch.empty((2, zl, Yl, X), device=dev)
            eps = torch.empty(_slots(dev, "pft_delta_eps_blocks", mode,
                                     2 if emit == "dy" else 1, zl, Yl, X),
                              device=dev)
            st.delta_g_shard_dev(spec, block, q, ws, kk, g, out,
                                 eps=eps if s5 else None, **kw)
            pairs.append((ref, (out, eps) if s5 else out))
    return pairs


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_shard_dev_entries_equal_by_value(dev, mode):
    """fused_stage_shard_dev (K1s, K3's interior and edge parts) and
    delta_g_shard_dev (K2s, both tails) against the by-value shard entries
    bit for bit, outputs and eps slots: every stage, on the shards of
    SHARDS (the tiles' edges, uneven y windows, the top shard with
    is_top) of SHAPE and of the same grid 52 wide, with t on each side of
    the phase switch; then a halted block, on which they write
    nothing."""
    prm = _params()
    h = 0.05
    for shape in (SHAPE, SHAPE[:2] + (52,)):
        geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
        spec = st.StencilSpec.of(geom, prm, mode)
        w, ks = _inputs(dev, shape)
        for t in (prm.phase_switch_time - 0.5 * h,
                  prm.phase_switch_time + 1.0):
            c, block = _control_block(dev, prm, t=t, h=h)
            pairs = []
            for lo, hi, rows, window in SHARDS:
                pairs += _shard_dev_pairs(dev, spec, c, block, w, ks, lo, hi,
                                          rows, window)
            torch.cuda.synchronize()
            for i, (ref, got) in enumerate(pairs):
                ref = ref if isinstance(ref, tuple) else (ref,)
                got = got if isinstance(got, tuple) else (got,)
                assert all(torch.equal(a, b) for a, b in zip(ref, got)), (
                    shape, t, i)
    # a halted block: the launches return at once
    c, block = _control_block(dev, prm, t=1.0, h=h, halt=1)
    lo, hi, rows, window = SHARDS[1]
    ws, kk, g = _shard_inputs(w, ks, 3, lo, hi, rows)
    kk = list(zip((0.5, -1.5, 2.0), kk))
    out = torch.full((2, hi - lo, window[1], w.shape[3]), 7.0, device=dev)
    eps = torch.full((_slots(dev, "pft_stage_eps_blocks", mode, 0, hi - lo,
                             window[1], w.shape[3]),), 7.0, device=dev)
    st.fused_stage_shard_dev(spec, block, 4, ws, kk, g, out, is_top=True,
                             window=window, stage5=True, eps=eps)
    eps_d = torch.full((_slots(dev, "pft_delta_eps_blocks", mode, 1,
                               hi - lo, window[1], w.shape[3]),), 7.0,
                       device=dev)
    st.delta_g_shard_dev(spec, block, 4, ws, kk, g, out, is_top=True,
                         window=window, stage5=True, eps=eps_d)
    torch.cuda.synchronize()
    assert (out == 7.0).all() and (eps == 7.0).all() and (eps_d == 7.0).all()


MR = (200, 100, 100)


@pytest.mark.parametrize("path", ["delta", "delta_comp", "stage"])
def test_mesh_device_loop_equals_host_loop_at_mr_z4(dev, path):
    """The device loop on a z4 mesh of virtual shards of cuda:0 (CUDA
    graphs of attempts on the shard kernels' _dev entries) against the
    host loop on the same mesh at the MR grid: 3 chunks of 25 attempts
    with a trace, state, t, h, counts and trace bit for bit; the commit
    kernel runs once a shard and attempt, the control kernel once an
    attempt (whole blocks of BLOCK, and the idle attempt before the
    capture)."""
    from porousfreezethaw_tpu_torch.ops.cuda import control
    from porousfreezethaw_tpu_torch.parallel import (
        make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.fused import (
        ShardedDeltaAttempt, ShardedStageAttempt, make_sharded_fused_stage)
    prm = _params()
    geom = GridGeometry(0.03, 0.03, 0.06, MR[2], MR[1], MR[0])
    w, _ = _inputs(dev, MR)
    w[0] = torch.linspace(-5, 5, MR[2], device=dev)
    mesh = make_mesh("z4", [dev] * 4)
    params = MersonParams(delta=1e-3, max_steps=25, record_trace=25,
                          handle_nan=True,
                          accept_growth_min=1.05 if path == "stage" else 0.0)
    if path == "stage":
        stage_fn = make_sharded_fused_stage(geom, prm, 0, mesh)
        att = ShardedStageAttempt(geom, prm, 0, mesh)

        def host(s):
            return merson_solve(None, s, 1e9, params, stage_fn=stage_fn)
    else:
        comp = path == "delta_comp"
        host_att, att = (ShardedDeltaAttempt(geom, prm, 0, mesh,
                                             compensated=comp)
                         for _ in range(2))

        def host(s):
            return merson_solve(None, s, 1e9, params, attempt_fn=host_att)
    sa = sb = merson_init(shard_freezing_state(w, mesh), 0.0, 1e-6)
    for call in range(3):
        a = host(sa)
        control.merson_control.launches = control.commit.launches = 0
        b = merson_solve_device(sb, 1e9, params, att)
        n = b[0].steps_total - sb.steps_total
        assert n == 25
        blocks = -(-n // control.BLOCK)
        assert control.merson_control.launches == (control.BLOCK * blocks
                                                   + (call == 0))
        assert control.commit.launches == 4 * control.merson_control.launches
        assert a[1] == b[1]
        assert (a[0].t, a[0].h, a[0].steps, a[0].steps_total) == (
            b[0].t, b[0].h, b[0].steps, b[0].steps_total)
        assert all(torch.equal(x, y) for x, y in zip(a[0].y, b[0].y))
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
        sa, sb = a[0], b[0]
    assert all(torch.isfinite(y).all() for y in sb.y)


def test_capture_survives_dropped_graphs(dev):
    """An attempt object and its loop hold each other, so a dropped one
    (with its captured graph) is freed by the cyclic collector; a
    collection during another object's capture would destroy that graph
    there and invalidate the capture.  With the collector run at every
    allocation, three mesh attempt objects in turn capture and solve, each
    dropped before the next."""
    import gc

    from porousfreezethaw_tpu_torch.parallel import (
        make_mesh, shard_freezing_state)
    from porousfreezethaw_tpu_torch.parallel.fused import ShardedDeltaAttempt
    prm = _params()
    shape = (20, 18, 37)
    geom = GridGeometry(0.03, 0.03, 0.06, shape[2], shape[1], shape[0])
    w, _ = _inputs(dev, shape)
    mesh = make_mesh("z2", [dev] * 2)
    params = MersonParams(delta=1e-3, max_steps=5, handle_nan=True)
    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for _ in range(3):
            att = ShardedDeltaAttempt(geom, prm, 0, mesh)
            st_, _ = merson_solve_device(
                merson_init(shard_freezing_state(w, mesh), 0.0, 1e-6), 1e9,
                params, att)
            assert st_.steps_total == 5
            del att
    finally:
        gc.set_threshold(*old)
    torch.cuda.synchronize()
