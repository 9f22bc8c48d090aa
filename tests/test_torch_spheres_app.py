"""The port's spheres app (``python -m porousfreezethaw_tpu_torch.apps.spheres``)
on the CPU against the JAX app, at the dense bed of 12 spheres, 6
snapshots to t = 0.3 (the case of tests/test_dem.py).

Tolerance: the snapshot values to 2e-6 (two units of the CSV's sixth
decimal: a state that differs from JAX's in its last bits may round the
other way), and the step counts of every console line equal."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.apps.spheres import main as jax_main
from porousfreezethaw_tpu_torch.apps import spheres
from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config import parse_param_file
from porousfreezethaw_tpu_torch.core.device import DeviceError
from porousfreezethaw_tpu_torch.io.csv_snaps import read_dem_snapshot
from porousfreezethaw_tpu_torch.models.dem import forces as dem_forces
from porousfreezethaw_tpu_torch.models.freezing import (
    FreezingParams, read_ball_positions)

torch.set_num_threads(1)

BASE = ["--variant", "friction_angular", "--n", "12", "--snapshots", "6",
        "--final-time", "0.3", "--seed", "5"]
STEPS = re.compile(r"(\d+) R-K steps \((\d+) total\)")


def run_port(out, *extra):
    assert spheres.main(BASE + ["--device", "cpu", "--output", str(out),
                                *extra]) == 0


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main(BASE + ["--platform", "cpu", "--output",
                                str(out)]) == 0
    return out, buf.getvalue()


def test_snapshots_and_step_counts_match_jax(tmp_path, capsys, jax_run):
    jout, jlog = jax_run
    run_port(tmp_path)
    log = capsys.readouterr().out
    names = sorted(p.name for p in tmp_path.glob("snap_*.csv"))
    assert names == [f"snap_{i:03d}.csv" for i in range(1, 7)]
    assert sorted(p.name for p in jout.glob("snap_*.csv")) == names
    for name in names:
        a = read_dem_snapshot(str(tmp_path / name))
        b = read_dem_snapshot(str(jout / name))
        assert list(a) == list(b) == ["x", "y", "z", "vx", "vy", "vz",
                                      "avx", "avy", "avz", "color"]
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-6,
                                       err_msg=f"{name}:{k}")
    counts = STEPS.findall(log)
    assert len(counts) == 6 and counts == STEPS.findall(jlog)
    assert counts[-1] != ("1", "1")
    for i in range(1, 7):
        assert f"Saving snapshot {i} of 6." in log
    assert "Simulation completed in:" in log


def test_device_buffer_is_byte_identical(tmp_path):
    a, b = tmp_path / "host", tmp_path / "buffered"
    run_port(a)
    run_port(b, "--device-buffer", "4")
    names = sorted(p.name for p in a.glob("snap_*.csv"))
    assert len(names) == 6
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_final_positions_read_by_the_glass_reader(tmp_path):
    """--final-positions writes the resting centres that the freezing
    app's reader takes (raw unit-box coordinates; the reader applies
    beads_scaling and beads_offset_*)."""
    path = tmp_path / "spheres_final_positions.txt"
    run_port(tmp_path, "--final-positions", str(path))
    last = read_dem_snapshot(str(tmp_path / "snap_006.csv"))
    raw = np.loadtxt(path)
    assert raw.shape == (12, 3)
    np.testing.assert_allclose(raw, np.stack([last["x"], last["y"],
                                              last["z"]], axis=1),
                               atol=1e-6)
    prm = FreezingParams.from_dict(parse_param_file(
        freezing_params_text(100, 0), env={"OUTPUT": "unused"}).vars)
    balls = read_ball_positions(str(path), prm)
    np.testing.assert_allclose(
        balls, raw * prm.beads_scaling + [prm.beads_offset_x,
                                          prm.beads_offset_y,
                                          prm.beads_offset_z],
        rtol=1e-15)


def test_f32_takes_the_nan_backoff(tmp_path, monkeypatch):
    seen = []
    real = dem_forces.merson_solve

    def spy(rhs, state, tf, params, **kw):
        seen.append(params.handle_nan)
        return real(rhs, state, tf, params, **kw)

    # the app's solves go through models.dem.solve_guarded
    monkeypatch.setattr(dem_forces, "merson_solve", spy)
    run_port(tmp_path / "f32", "--precision", "f32")
    run_port(tmp_path / "f64")
    assert seen == [True] * 6 + [False] * 6
    assert len(list((tmp_path / "f32").glob("snap_*.csv"))) == 6


def test_cell_lanes_tracks_dense(tmp_path, capsys):
    """--neighbor cell_lanes: the dense run's snapshots within 2e-6 and its
    step counts on every console line (the same pairs, summed in another
    order)."""
    run_port(tmp_path / "dense")
    dense = STEPS.findall(capsys.readouterr().out)
    run_port(tmp_path / "cells", "--neighbor", "cell_lanes",
             "--cell-capacity", "8")
    assert STEPS.findall(capsys.readouterr().out) == dense
    for i in range(1, 7):
        a = read_dem_snapshot(str(tmp_path / "cells" / f"snap_{i:03d}.csv"))
        b = read_dem_snapshot(str(tmp_path / "dense" / f"snap_{i:03d}.csv"))
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-6,
                                       err_msg=f"{i}:{k}")


def test_mesh_p2_is_byte_identical(tmp_path, capsys):
    """--mesh p2 (two virtual shards of the CPU) runs the sharded dense
    term: the snapshots of the run without a mesh, byte for byte."""
    run_port(tmp_path / "single")
    single = STEPS.findall(capsys.readouterr().out)
    run_port(tmp_path / "mesh", "--mesh", "p2")
    out = capsys.readouterr().out
    assert "Particles sharded over mesh {'p': 2}" in out
    assert STEPS.findall(out) == single
    for i in range(1, 7):
        name = f"snap_{i:03d}.csv"
        assert ((tmp_path / "single" / name).read_bytes()
                == (tmp_path / "mesh" / name).read_bytes()), name


def test_cell_overflow_stops_with_the_jax_message(tmp_path):
    """The dense bed of 200 holds 2 spheres in its fullest cell: at
    capacity 1 the first occupancy check (after the solve to snapshot 0,
    whose step of h = 0 already met the NaN of the guarded capacity)
    stops the run."""
    with pytest.raises(SystemExit, match=r"cell occupancy \d+ exceeds "
                       "capacity 1 at t=0.0000: rerun with a larger "
                       "--cell-capacity or --neighbor dense"):
        spheres.main(["--n", "200", "--snapshots", "2", "--final-time",
                      "0.01", "--neighbor", "cell_lanes", "--cell-capacity",
                      "1", "--device", "cpu", "--output", str(tmp_path)])
    assert not list(tmp_path.glob("snap_*.csv"))


def test_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """cell_roll is not ported and names cell_lanes; the particle mesh is
    dense-only, as in JAX; 'cuda' without a GPU raises.  (cell_lanes and
    --mesh, once refused, run: see the tests above.)"""
    with pytest.raises(SystemExit):
        run_port(tmp_path, "--neighbor", "cell_roll")
    assert "use 'cell_lanes'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_port(tmp_path, "--neighbor", "cell_lanes", "--mesh", "p2")
    assert "dense neighbor strategy" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        spheres.main(BASE + ["--output", str(tmp_path)])
    assert not list(tmp_path.glob("snap_*.csv"))
