"""The app's chunked device-loop branch (the one on the card for every
path) on the CPU, through the plain versions of its kernels
(``intertrack.uses_device_loop`` patched to take it there), against the
host-loop branch on the 12-node case of tests/test_intertrack_app.py:
the same snapshots byte for byte and the same RK debug log lines (step,
t, tau, snapshot; not the wall-clock fields) for the increment form, its
compensated commit and the classic stage, and for the plain right-hand
side in f64 and in f32 with a noise field, across the Dirichlet top's
switch; the same on a mesh of virtual CPU shards (the halo path at z2 in
f64, the z2 delta attempt, its compensated commit, the z2 classic stage
and the z2,y2 attempt); a mesh run on the CPU keeping the host loop by
the rule, and the chunked branch naming the mesh; a trigger file taken at
the next chunk boundary, after which the run goes on as if untriggered;
and PFT_SERVICE_CHUNK's check."""

import os
import re
from unittest import mock

import pytest
import torch

from porousfreezethaw_tpu_torch.apps import intertrack
from porousfreezethaw_tpu_torch.apps.intertrack import main as torch_main
from porousfreezethaw_tpu_torch.io.netcdf3 import read_netcdf
from tests.test_intertrack_app import BASE

torch.set_num_threads(1)

SNAPS = ("image.000.ncd", "image.001.ncd", "image.002.ncd")
CHUNK = 6
STEP = re.compile(r"step (\d+), t=\s*(\S+), tau=\s*(\S+), .*"
                  r"Est\. time to snapshot (\d+) \(t=\s*(\S+)\)")


def run(out_dir, params_text, controller, precision="f32", extra_argv=()):
    """The app on the CPU with the step control ``controller``, "host" (its
    own on the CPU) or "device" (the chunked branch); (its log, the RK
    debug log's step fields)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    debug = out_dir / "rk.log"
    pfile = out_dir / "Params"
    pfile.write_text(params_text + f"\nset debug_logfile = {debug}\n")
    old = os.environ.get("OUTPUT")
    os.environ["OUTPUT"] = str(out_dir)
    device_loop = ((lambda device, mesh: True)
                   if controller == "device" else intertrack.uses_device_loop)
    try:
        with mock.patch.object(intertrack, "uses_device_loop", device_loop):
            rc = torch_main([str(pfile), "--precision", precision,
                             "--device", "cpu", *extra_argv])
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
    assert rc == 0
    log = (out_dir / "intertrack.log").read_text()
    steps = [STEP.search(ln).groups() for ln in
             debug.read_text().splitlines() if ln.strip()]
    return log, steps


# the plain right-hand side's paths (models/freezing/attempt.py
# PlainAttempt) cross the Dirichlet top's switch at t = 3.7 s
SWITCH = "phase_switch_time 3.7\n"


@pytest.mark.parametrize("precision,extra,mesh", [
    pytest.param("f32", "", None, id="delta"),
    pytest.param("f32", "compensated_commit 1\n", None, id="compensated"),
    pytest.param("f32", "increment_form 0\n", None, id="stage"),
    pytest.param("f64", SWITCH, None, id="f64"),
    pytest.param("f32", "u_noise_amp 0.5\n" + SWITCH, None, id="noise_f32"),
    pytest.param("f64", SWITCH, "z2", id="f64_halo_z2"),
    pytest.param("f32", "", "z2", id="delta_z2"),
    pytest.param("f32", "compensated_commit 1\n", "z2",
                 id="compensated_z2"),
    pytest.param("f32", "increment_form 0\n", "z2", id="stage_z2"),
    pytest.param("f32", "", "z2,y2", id="delta_z2,y2")])
def test_chunked_branch_equals_host_loop(tmp_path, monkeypatch, precision,
                                         extra, mesh):
    monkeypatch.setenv("PFT_SERVICE_CHUNK", str(CHUNK))
    argv = ("--mesh", mesh) if mesh else ()
    log_h, steps_h = run(tmp_path / "host", BASE + extra, "host", precision,
                         argv)
    log_d, steps_d = run(tmp_path / "device", BASE + extra, "device",
                         precision, argv)
    assert "Step control: host loop (--device cpu)" in log_h
    assert f"chunks of {CHUNK} attempts" in log_d
    if mesh:
        # the mesh path the app chose, the same in both branches
        path = ("Plain right-hand side with halo copies" if precision == "f64"
                else "sharded over z=2")
        assert path in log_h and path in log_d
    # more accepted steps than one chunk holds: several chunks drained
    assert len(steps_d) > 2 * CHUNK
    assert steps_d == steps_h
    assert [int(s[0]) for s in steps_d] == list(range(1, len(steps_d) + 1))
    for name in SNAPS:
        assert ((tmp_path / "device" / name).read_bytes()
                == (tmp_path / "host" / name).read_bytes()), name
    counts = [re.search(r"Successful R-K steps: (\d+) of (\d+)", lg).groups()
              for lg in (log_h, log_d)]
    assert counts[0] == counts[1]


def test_mesh_keeps_the_host_loop(tmp_path, monkeypatch):
    """The loop of an f64 run on a z2 mesh (the plain right-hand side with
    halo copies) follows the one rule: on the CPU the mesh keeps the host
    loop and the log says why; where the rule takes the device loop (the
    card; patched here), the mesh takes the chunked branch, whose log
    names the mesh, and the RK debug log is the host loop's."""
    monkeypatch.setenv("PFT_SERVICE_CHUNK", str(CHUNK))
    argv = ("--mesh", "z2")
    log_h, steps_h = run(tmp_path / "host", BASE, "host", "f64", argv)
    assert "Plain right-hand side with halo copies" in log_h
    assert "Step control: host loop (--device cpu)" in log_h
    log_d, steps_d = run(tmp_path / "device", BASE, "device", "f64", argv)
    assert "Plain right-hand side with halo copies" in log_d
    assert ("Step control: device loop (CUDA graphs of 32 attempts on the "
            "card; the mesh {'z': 2}, 2 shards on cpu), chunks of "
            f"{CHUNK} attempts") in log_d
    assert steps_d == steps_h and len(steps_d) > CHUNK


def test_trigger_file_taken_at_the_chunk_boundary(tmp_path, monkeypatch):
    """A trigger file present from the start: the host loop takes it after
    the first accepted step, the chunked branch after its first chunk of
    CHUNK attempts.  The on-demand snapshot holds the state at that
    boundary, the trigger is removed, and the run then goes on exactly as
    an untriggered one (a chunk boundary is a seamless restart)."""
    monkeypatch.setenv("PFT_SERVICE_CHUNK", str(CHUNK))
    _, steps_plain = run(tmp_path / "plain", BASE, "device")
    out = tmp_path / "trig"
    out.mkdir()
    trigger = out / "t"
    trigger.write_text("")
    log, steps = run(out, BASE + f"set snapshot_trigger = {trigger}\n",
                     "device")
    assert not trigger.exists()
    m = re.search(r"On-demand snapshot triggered .*?(\d+) R-K steps, "
                  r"t=(\S+)", log)
    n_at = int(m[1])
    # the first chunk's accepted steps, more than the host loop's one
    assert 1 < n_at <= CHUNK
    snap = read_netcdf(str(out / "image.000.000.ncd"))
    assert float(snap.attrs["t"]) == pytest.approx(
        float(steps[n_at - 1][1]), rel=1e-4)
    assert steps == steps_plain
    assert ((out / SNAPS[2]).read_bytes()
            == (tmp_path / "plain" / SNAPS[2]).read_bytes())


@pytest.mark.parametrize("value", ["0", "-3", "many"])
def test_service_chunk_must_be_a_positive_integer(monkeypatch, value):
    monkeypatch.setenv("PFT_SERVICE_CHUNK", value)
    with pytest.raises(SystemExit, match="positive integer"):
        intertrack.service_chunk()


def test_service_chunk_default(monkeypatch):
    monkeypatch.delenv("PFT_SERVICE_CHUNK", raising=False)
    assert intertrack.service_chunk() == 1024
