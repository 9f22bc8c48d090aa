"""The port's bench entry point (``python -m porousfreezethaw_tpu_torch.bench``)
on the CPU at a tiny grid: its one-JSON-line contract and metric names
against the JAX package's ``bench.py``, the Merson parameters of each
path, and what it refuses (the DEM suite, which is not
ported yet, and a GPU it does not have).  ``--matrix`` prints its rows and
writes no BENCH_MATRIX.json."""

import json
import os
import subprocess
import sys

import pytest
import torch

from porousfreezethaw_tpu_torch import bench
from porousfreezethaw_tpu_torch.core.device import DeviceError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--grid-nodes", "8", "--steps", "5",
        "--warm-steps", "5"]
KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_attempt"}


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("fused,dtype,growth", [
    ("off", "f64", 0.0), ("stage", "f32", 1.05), ("delta", "f32", 0.0),
    ("attempt", "f32", 0.0)])
def test_json_contract(fused, dtype, growth, capsys, monkeypatch):
    """One JSON line with bench.py's keys and unit; 5 timed attempts after
    5 warm ones; accept_growth_min 1.05 only for the classic f32 path."""
    seen = []
    real = bench.merson_solve

    def spy(rhs, state, tf, params, **kw):
        seen.append(params)
        return real(rhs, state, tf, params, **kw)

    monkeypatch.setattr(bench, "merson_solve", spy)
    assert bench.main(TINY + ["--fused", fused, "--dtype", dtype]) == 0
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 1
    rec = last_json(out)
    assert KEYS <= set(rec)
    assert rec["metric"] == "freezing_gradp_8_cell_rhs_evals_per_s"
    assert rec["unit"] == "cell*RHS-evals/s/chip"
    assert rec["value"] > 0 and rec["ms_per_attempt"] > 0
    assert rec["vs_baseline"] is None            # no reference at 8 nodes
    assert (rec["device"], rec["fused"], rec["dtype"]) == ("cpu", fused,
                                                           dtype)
    assert rec["attempts"] == 5 and rec["warm_attempts"] == 5
    assert rec["grid"] == [4, 4, 8]
    assert {p.accept_growth_min for p in seen} == {growth}
    assert {p.max_steps for p in seen} == {5}


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    """--profile-dir traces the timed section with torch.profiler."""
    assert bench.main(TINY + ["--fused", "delta", "--profile-dir",
                              str(tmp_path)]) == 0
    assert last_json(capsys.readouterr().out)["attempts"] == 5
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("ph") == "X" for ev in trace["traceEvents"])


def test_metric_names_follow_bench_py():
    """The JAX bench's record at the same tiny case has the same metric,
    unit and keys; the headline name belongs to MR GradP."""
    out = subprocess.run(
        [sys.executable, "bench.py", "--platform", "cpu", "--grid-nodes",
         "8", "--steps", "5", "--warm-steps", "5", "--dtype", "f64",
         "--fused", "off"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    want = last_json(out.stdout)
    assert bench.metric_name(8, 0) == want["metric"]
    assert want["unit"] == bench.UNIT and set(want) <= KEYS
    assert bench.metric_name(200, 0) == bench.HEADLINE == \
        "freezing_gradp_cell_rhs_evals_per_s"
    assert bench.metric_name(100, 2) == "freezing_temp_lr_cell_rhs_evals_per_s"
    assert bench.metric_name(400, 1) == \
        "freezing_sigmap_hr_cell_rhs_evals_per_s"


def test_not_ported_yet():
    """The DEM suite and its matrix rows raise; the mesh rows run (their
    f64 form is refused: the mesh paths are the f32 kernels')."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        bench.main(["--suite", "dem", "--device", "cpu"])
    with pytest.raises(ValueError, match="f32 kernel paths"):
        bench.main(["--mesh", "z", "--device", "cpu", "--dtype", "f64"])
    args = bench.parse_args(TINY)
    for spec, _ in bench.matrix_specs():
        if spec.startswith("dem:"):
            with pytest.raises(NotImplementedError, match="not ported yet"):
                bench.bench_row(args, spec)


def test_not_ported_row_in_its_own_process():
    """A matrix row runs in a process of its own; an unported one exits
    non-zero and becomes an error record."""
    rec = bench.run_row("dem:200:dense:512", "dem_200_dense",
                        bench.parse_args(TINY))
    assert rec["value"] is None and rec["rc"] != 0
    assert "not ported yet" in rec["error"]


def test_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="float32 only"):
        bench.main(TINY + ["--fused", "stage", "--dtype", "f64"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        bench.main(["--grid-nodes", "8", "--steps", "1"])


def test_matrix_writes_only_where_asked(tmp_path, monkeypatch, capsys):
    """--matrix prints one line per row and the headline last, writes no
    BENCH_MATRIX.json (in the working directory or the repo), and writes
    its rows to --out."""
    tracked = os.path.join(REPO, "BENCH_MATRIX.json")
    before = open(tracked, "rb").read()
    ran = []

    def fake_row(spec, label, args):
        ran.append(spec)
        if spec.startswith("dem:"):
            return {"metric": label, "value": None, "unit": None,
                    "vs_baseline": None, "error": "not ported yet", "rc": 1}
        gn, cm = (int(x) for x in spec.split(":")[1:3])
        name = bench.metric_name(gn, cm) + ("_delta" if "delta" in spec
                                            else "")
        return {"metric": name, "value": 1.0, "unit": bench.UNIT,
                "vs_baseline": None, "ms_per_attempt": 1.0}

    monkeypatch.setattr(bench, "run_row", fake_row)
    monkeypatch.chdir(tmp_path)
    assert bench.main(["--matrix", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    specs = [s for s, _ in bench.matrix_specs()]
    assert ran == specs and len(specs) == 20
    assert len(lines) == len(specs) + 1
    assert json.loads(lines[-1])["metric"] == bench.HEADLINE
    assert sum(1 for ln in lines[:-1] if json.loads(ln)["value"]) == 12
    assert os.listdir(tmp_path) == []
    assert open(tracked, "rb").read() == before

    out = tmp_path / "rows.json"
    assert bench.main(["--matrix", "--device", "cpu", "--out",
                       str(out)]) == 0
    assert [r["metric"] for r in json.loads(out.read_text())] == [
        json.loads(ln)["metric"] for ln in lines[:-1]]
    assert os.listdir(tmp_path) == ["rows.json"]
