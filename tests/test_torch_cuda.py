"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version at a small odd shape, and a short solve whose launch
counters show that every attempt went through both kernels.

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
