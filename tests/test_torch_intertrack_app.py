"""The port's intertrack app (``--device cpu``) against the JAX app on the
12-node case of tests/test_intertrack_app.py: the f64 path, the f32
increment-form path, resume from a JAX-written checkpoint, and resume
within the port."""

import os
import re

import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.apps.intertrack import main as jax_main
from porousfreezethaw_tpu_torch.apps.intertrack import main as torch_main
from porousfreezethaw_tpu_torch.io.netcdf3 import read_netcdf
from tests.test_intertrack_app import BASE

torch.set_num_threads(1)

SNAPS = ("image.000.ncd", "image.001.ncd", "image.002.ncd")


def run(main, out_dir, params_text, argv=()):
    out_dir.mkdir(parents=True, exist_ok=True)
    pfile = out_dir / "Params"
    pfile.write_text(params_text)
    old = os.environ.get("OUTPUT")
    os.environ["OUTPUT"] = str(out_dir)
    try:
        rc = main([str(pfile), *argv])
    finally:
        if old is None:
            os.environ.pop("OUTPUT", None)
        else:
            os.environ["OUTPUT"] = old
    assert rc == 0
    return out_dir


def counts(out_dir):
    log = (out_dir / "intertrack.log").read_text()
    m = re.search(r"Successful R-K steps: (\d+) of (\d+) total", log)
    assert m, log[-1000:]
    return int(m[1]), int(m[2])


def fields(path):
    d = read_netcdf(str(path))
    return {v: np.asarray(d.variables[v]) for v in ("u", "p", "gl")}, d.attrs


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    return run(jax_main, tmp_path_factory.mktemp("jax_f64"), BASE)


@pytest.fixture(scope="module")
def port_f64(tmp_path_factory):
    return run(torch_main, tmp_path_factory.mktemp("port_f64"), BASE,
               ("--device", "cpu"))


def test_f64_matches_jax_app(jax_f64, port_f64):
    """Steps and attempts within 1; snapshot fields to rtol 1e-9 (atol
    1e-12 for the phase fields' exact zeros)."""
    (s_j, a_j), (s_t, a_t) = counts(jax_f64), counts(port_f64)
    assert abs(s_t - s_j) <= 1 and abs(a_t - a_j) <= 1
    for name in SNAPS:
        fj, attrs_j = fields(jax_f64 / name)
        ft, attrs_t = fields(port_f64 / name)
        for v in fj:
            np.testing.assert_allclose(ft[v], fj[v], rtol=1e-9, atol=1e-12)
        assert attrs_t["t"] == pytest.approx(attrs_j["t"], rel=1e-12)
        assert attrs_t["snapshot"] == attrs_j["snapshot"]
    log = (port_f64 / "intertrack.log").read_text()
    assert "completed successfully" in log


def test_f32_delta_path_matches_jax_app(tmp_path, monkeypatch):
    """The f32 increment-form path (the kernel wrappers' plain versions on
    the CPU) completes with counts within 2% of the JAX app's Pallas path
    run in interpret mode."""
    monkeypatch.setenv("PFT_FUSED_INTERPRET", "1")
    jd = run(jax_main, tmp_path / "jax", BASE, ("--precision", "f32"))
    td = run(torch_main, tmp_path / "port", BASE,
             ("--precision", "f32", "--device", "cpu"))
    log = (td / "intertrack.log").read_text()
    assert "Increment-form (delta) attempt kernels: ON (cpu)" in log
    (s_j, a_j), (s_t, a_t) = counts(jd), counts(td)
    assert abs(s_t - s_j) <= 0.02 * s_j and abs(a_t - a_j) <= 0.02 * a_j
    ft, _ = fields(td / "image.002.ncd")
    fj, _ = fields(jd / "image.002.ncd")
    assert all(np.isfinite(ft[v]).all() for v in ft)
    np.testing.assert_allclose(ft["u"], fj["u"], rtol=0, atol=1e-3)


def test_resume_from_jax_checkpoint(jax_f64, port_f64, tmp_path):
    """A snapshot the JAX app wrote resumes in the port through
    continue_series and lands on the JAX run's next snapshot."""
    params = BASE + (f"\nset icond_file = {jax_f64}/image.001.ncd\n"
                     "set continue_series\n")
    rd = run(torch_main, tmp_path / "resumed", params, ("--device", "cpu"))
    assert not (rd / "image.000.ncd").exists()
    fr, attrs = fields(rd / "image.002.ncd")
    fj, attrs_j = fields(jax_f64 / "image.002.ncd")
    for v in fr:
        np.testing.assert_allclose(fr[v], fj[v], rtol=1e-9, atol=1e-12)
    assert attrs["t"] == attrs_j["t"] == pytest.approx(5.0)
    log = (rd / "intertrack.log").read_text()
    assert "Series continuation mode has been requested." in log


def test_resume_equals_uninterrupted(port_f64, tmp_path):
    """Resume in the port is byte-identical to its own uninterrupted run
    (t, tau and the snapshot index restored from the checkpoint).  f64
    only, as in the JAX package: an f32 run stores u - u* and its
    snapshot holds u, so re-shifting a resumed f32 state rounds."""
    params = BASE + (f"\nset icond_file = {port_f64}/image.001.ncd\n"
                     "set continue_series\n")
    rd = run(torch_main, tmp_path / "resumed", params, ("--device", "cpu"))
    for name in SNAPS[1:]:
        assert (rd / name).read_bytes() == (port_f64 / name).read_bytes(), \
            name


def test_classic_stage_path_trigger_and_debug_log(tmp_path):
    """``increment_form 0`` selects the classic fused stage (with the f32
    noise-floor escape); a trigger file writes an on-demand snapshot, and
    the RK debug log gets one line per accepted step."""
    trigger = tmp_path / "out" / "t"
    trigger.parent.mkdir()
    trigger.write_text("")
    debug = tmp_path / "out" / "rk.log"
    params = BASE + (f"\nincrement_form\t0\nset snapshot_trigger = {trigger}\n"
                     f"set debug_logfile = {debug}\n")
    td = run(torch_main, tmp_path / "out", params,
             ("--precision", "f32", "--device", "cpu"))
    log = (td / "intertrack.log").read_text()
    assert "Fused stage kernel: ON (cpu)" in log
    assert "accept-side minimum h growth 1.05" in log
    assert (td / "image.000.000.ncd").exists() and not trigger.exists()
    fr, _ = fields(td / "image.002.ncd")
    assert np.isfinite(fr["u"]).all()
    steps, _ = counts(td)
    lines = [ln for ln in debug.read_text().splitlines() if ln.strip()]
    assert len(lines) >= steps


def test_mesh_not_ported(tmp_path, monkeypatch):
    """The mesh paths are f32: --mesh with f64 (the default precision) is
    the JAX app's GSPMD fallback, which is not ported yet."""
    (tmp_path / "Params").write_text(BASE)
    monkeypatch.setenv("OUTPUT", str(tmp_path))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch_main([str(tmp_path / "Params"), "--mesh", "z", "--device",
                    "cpu"])


@pytest.mark.slow
def test_lr_gradp_golden_plain_cpu(tmp_path):
    """The LR GradP golden (tests/test_golden_lr.py) through the port's app
    on the CPU, i.e. the plain versions of both kernels: snapshot 1 within
    5% of the reference log's 3560 successful / 4322 attempted steps."""
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", "Params-LR-GradP")
    text = open(golden).read()
    text = re.sub(r"final_time\s+\S+", "final_time 10*hours/99", text)
    text = re.sub(r"saved_files\s+\S+", "saved_files 2", text)
    text += ("\nset ball_positions_file = " + os.path.join(
        os.path.dirname(golden), "..", "..", "data", "spheres_positions.txt")
        + "\n")
    out = run(torch_main, tmp_path, text,
              ("--precision", "f32", "--device", "cpu"))
    steps, attempts = counts(out)
    assert abs(steps - 3560) <= 0.05 * 3560
    assert abs(attempts - 4322) <= 0.05 * 4322
