"""The port's bench entry point (``python -m porousfreezethaw_tpu_torch.bench``)
on the CPU at a tiny grid: its one-JSON-line contract and metric names
against the JAX package's ``bench.py``, the Merson parameters of each
path, the DEM suite's rows (dense and the cell strategies), and what it
refuses (an f64 mesh, cell_roll, a GPU it does not have).  ``--matrix``
prints its rows and writes no BENCH_MATRIX.json."""

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


def test_not_ported_yet(capsys):
    """The cell strategies, once not ported, run: --suite dem with
    cell_lanes and cell_list and a cell_lanes matrix row give bench.py's
    metric names (``_celllanes``, ``_celllist``) with the row's capacity
    and the fullest cell seen; the matrix has bench.py's four cell_lanes
    rows; cell_roll raises and names cell_lanes; the f64 mesh is refused
    (the mesh rows are the f32 kernels', as in bench.py)."""
    for neighbor, suffix in (("cell_lanes", "_celllanes"),
                             ("cell_list", "_celllist")):
        assert bench.main(["--suite", "dem", "--neighbor", neighbor,
                           "--n-spheres", "12", "--cell-capacity", "8",
                           "--device", "cpu", "--steps", "3",
                           "--warm-steps", "3"]) == 0
        rec = last_json(capsys.readouterr().out)
        assert rec["metric"] == f"dem_12{suffix}_particle_rhs_evals_per_s"
        assert (rec["neighbor"], rec["cell_capacity"]) == (neighbor, 8)
        assert 1 <= rec["max_occupancy"] <= 8 and rec["attempts"] == 3
    with pytest.raises(ValueError, match="cell_lanes"):
        bench.main(["--suite", "dem", "--neighbor", "cell_roll",
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="f32 kernel paths"):
        bench.main(["--mesh", "z", "--device", "cpu", "--dtype", "f64"])
    lanes = [s for s, _ in bench.matrix_specs() if ":cell_lanes:" in s]
    assert lanes == [f"dem:{n}:cell_lanes:512:8"
                     for n in (4000, 6000, 10000, 20000)]
    rec = bench.bench_row(bench.parse_args(["--device", "cpu", "--steps",
                                            "2", "--warm-steps", "2"]),
                          "dem:500:cell_lanes:512:8")
    assert rec["metric"] == "dem_500_celllanes_particle_rhs_evals_per_s"
    assert rec["cell_capacity"] == 8 and rec["value"] > 0


def test_not_ported_row_in_its_own_process():
    """A matrix row runs in a process of its own: the cell_lanes row at
    4000 spheres (capacity 8), once not ported, gives its record."""
    rec = bench.run_row("dem:4000:cell_lanes:512:8", "dem_4000_cell_lanes_k8",
                        bench.parse_args(TINY))
    assert "rc" not in rec and "error" not in rec
    assert rec["metric"] == "dem_4000_celllanes_particle_rhs_evals_per_s"
    assert rec["value"] > 0 and rec["n_spheres"] == 4000
    assert (rec["cell_capacity"], rec["attempts"]) == (8, 5)
    assert rec["max_occupancy"] <= 8


@pytest.mark.parametrize("argv", [
    ["--suite", "dem", "--n-spheres", "12"],
    ["--row", "dem:12:dense:512"]])
def test_dem_suite(argv, capsys):
    """--suite dem and a dense DEM matrix row: one JSON line under
    bench.py's DEM metric name, 5 timed attempts after 5 warm ones of the
    f32 dense pair term."""
    assert bench.main(argv + ["--device", "cpu", "--steps", "5",
                              "--warm-steps", "5"]) == 0
    rec = last_json(capsys.readouterr().out)
    assert rec["metric"] == "dem_12_particle_rhs_evals_per_s"
    assert rec["unit"] == "particle*RHS-evals/s/chip"
    assert rec["value"] > 0 and rec["vs_baseline"] is None
    assert (rec["attempts"], rec["warm_attempts"]) == (5, 5)
    assert (rec["device"], rec["dtype"], rec["neighbor"]) == (
        "cpu", "f32", "dense")


def test_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="float32 only"):
        bench.main(TINY + ["--fused", "stage", "--dtype", "f64"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        bench.main(["--grid-nodes", "8", "--steps", "1"])


def test_matrix_writes_only_where_asked(tmp_path, monkeypatch, capsys):
    """--matrix prints one line per row and the headline last, writes no
    BENCH_MATRIX.json (in the working directory or the repo), and writes
    its rows to --out; a row that fails (every DEM row ran since the cell
    list was ported) makes it exit 1."""
    tracked = os.path.join(REPO, "BENCH_MATRIX.json")
    before = open(tracked, "rb").read()
    ran = []
    failing = set()

    def fake_row(spec, label, args):
        ran.append(spec)
        if spec in failing:
            return {"metric": label, "value": None, "unit": None,
                    "vs_baseline": None, "error": "failed", "rc": 1}
        if spec.startswith("dem:"):
            return {"metric": label, "value": 1.0, "unit": bench.DEM_UNIT,
                    "vs_baseline": None, "ms_per_attempt": 1.0}
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
    assert sum(1 for ln in lines[:-1] if json.loads(ln)["value"]) == 20
    assert os.listdir(tmp_path) == []
    assert open(tracked, "rb").read() == before

    out = tmp_path / "rows.json"
    assert bench.main(["--matrix", "--device", "cpu", "--out",
                       str(out)]) == 0
    assert [r["metric"] for r in json.loads(out.read_text())] == [
        json.loads(ln)["metric"] for ln in lines[:-1]]
    assert os.listdir(tmp_path) == ["rows.json"]
    failing.add("dem:20000:cell_lanes:512:8")
    assert bench.main(["--matrix", "--device", "cpu"]) == 1
