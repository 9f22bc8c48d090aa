"""The yardstick's arithmetic at tiny shapes: the bytes and operations of
one attempt, a stage kernel's bytes from its name, and the roofline and
idle readers on a made-up record."""

import pytest

from cellbench_tiny import BENCH

from benchmark import harness

work = harness.load_module(BENCH / "work" / "freezing.py")


def test_attempt_bytes_are_five_planes():
    assert work.attempt_bytes(1, 4) == 20
    assert work.attempt_bytes(4 * 4 * 8, 8) == 5 * 128 * 8
    # MR in float32: 40 MB; HR: 320 MB
    assert work.attempt_bytes(100 * 100 * 200, 4) == 40_000_000
    assert work.attempt_bytes(200 * 200 * 400, 4) == 320_000_000


@pytest.mark.parametrize("mode", [0, 1, 2, 10, 11])
def test_attempt_ops_count_five_rhs_and_the_merson_combination(mode):
    per_cell = 5 * work.rhs_ops(mode) + 2 * work.MERSON_PER_FIELD
    assert work.attempt_ops(1, mode) == per_cell
    assert work.attempt_ops(128, mode) == 128 * per_cell


def test_frozen_temperature_modes_count_no_heat_equation():
    assert work.rhs_ops(0) - work.rhs_ops(10) == work.DU_DT
    assert work.rhs_ops(1) - work.rhs_ops(11) == work.DU_DT
    assert work.rhs_ops(2) > work.DIV_LAMBDA_GRAD_U


def test_same_count_for_every_path_of_a_configuration():
    # the yardstick depends on the grid, the calc mode and the width only
    a = work.attempt_ops(2_000_000, 0), work.attempt_bytes(2_000_000, 4)
    assert a == (work.attempt_ops(2_000_000, 0),
                 work.attempt_bytes(2_000_000, 4))


@pytest.mark.parametrize("name,planes", [
    ("void pft::delta_g_kernel<0, 2, 0, true>(pft::Consts, ...)", 9),
    ("void pft::fused_stage_kernel<2, 0, 0, true>(pft::Consts, ...)", 5),
    ("void pft::delta_g_kernel<2, 3, 1, true>(pft::Consts, ...)", 11),
])
def test_kernel_bytes_from_template_arguments(name, planes):
    assert work.kernel_bytes(name, 10, 4) == planes * 10 * 4


def test_kernel_bytes_unknown_kernels():
    assert work.kernel_bytes("pft::merson_control_kernel(pft::Control*)",
                             10, 4) is None
    assert work.kernel_bytes("void pft::commit_kernel<0, 4>(...)", 10,
                             4) is None


PEAKS = {"card": {"bytes_per_s": 1e12, "flops_per_s": {"float32": 1e13}}}


def _rec(busy, window, attempts=10, nbytes=1e9, ops=1e9):
    return {"device_kind": "card",
            "work": {"bytes_per_attempt": nbytes, "ops_per_attempt": ops,
                     "dtype": "float32"},
            "trace": {"busy_s": busy, "window_s": window,
                      "attempts": attempts, "launches": 70}}


def test_attempt_roofline_reader():
    roof = harness.load_module(BENCH / "metrics" / "attempt_roofline.py")
    # 1 GB at 1 TB/s is 1 ms an attempt; 10 attempts in 20 ms busy: 50%
    assert roof.read(_rec(0.02, 0.025), PEAKS) == pytest.approx(50.0)
    # operations bound it: 1e11 / 1e13 = 10 ms an attempt of 20 ms
    assert roof.read(_rec(0.2, 0.25, ops=1e11), PEAKS) == pytest.approx(50.0)
    assert roof.read(_rec(0.02, 0.025), {}) is None
    assert roof.read({"trace": None}, PEAKS) is None


def test_idle_and_launch_readers():
    idle = harness.load_module(BENCH / "metrics" / "device_idle_share.py")
    lpa = harness.load_module(BENCH / "metrics" / "launches_per_attempt.py")
    assert idle.read(_rec(0.02, 0.025), PEAKS) == pytest.approx(20.0)
    assert lpa.read(_rec(0.02, 0.025), PEAKS) == pytest.approx(7.0)
    assert idle.read({"trace": None}, PEAKS) is None
