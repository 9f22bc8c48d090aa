"""The command itself: no result without a card, none in a checkout that
holds only the benchmark, and the trace's reduction on made-up events.
The card's own run is marked ``cuda`` and skips here."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from cellbench_tiny import ROOT

from benchmark import profiling

ARGS = ["--workload", "mr-gradp.f32", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=str(cwd), capture_output=True, text=True,
                          timeout=300, env=env)


def _no_result(out):
    assert out.returncode != 0
    assert not any(line.startswith("{")
                   for line in out.stdout.splitlines())


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _no_result(_run(ROOT))


def test_no_result_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path, env={"PATH": "/usr/bin:/bin"}))


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _ev("user_annotation", profiling.WINDOW, 0.0, 100.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 0.0, 12.0),
        _ev("kernel", "k_a", 10.0, 20.0),
        _ev("kernel", "k_b", 25.0, 15.0),      # overlaps k_a: union 10-40
        _ev("cuda_runtime", "cudaMemcpyAsync", 45.0, 20.0),
        _ev("gpu_memcpy", "Memcpy DtoH", 60.0, 5.0),
        _ev("kernel", "k_a", 70.0, 20.0),
        _ev("kernel", "late", 150.0, 10.0),    # outside the window
    ]
    r = profiling.reduce_events(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(55e-6)
    assert r["launches"] == 3
    assert r["launch_counts"] == {"k_a": 2, "k_b": 1}
    assert r["device_ops"][0] == ["k_a", pytest.approx(40e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(45e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the chip)")


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
