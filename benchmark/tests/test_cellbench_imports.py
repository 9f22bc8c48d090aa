"""What the harness loads: no JAX and no JAX package in the process that
prints the result, and nothing of the program in the plain reference.
Module names are compared whole, by their top-level name: the port's name
begins with the JAX package's."""

import ast
import json
import subprocess
import sys

from cellbench_tiny import BENCH, ROOT

from benchmark import harness

# a tiny run on the CPU in a fresh interpreter, then its loaded modules
RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from benchmark import harness
from cellbench_tiny import spec, tiny
import os
os.environ["PFT_SERVICE_CHUNK"] = "32"
cell, extra = tiny(harness.load_cell({name!r}, spec()))
rec = harness.run_cell(cell, 7, 0.2, False, device=torch.device("cpu"),
                       t_process=time.perf_counter(), grid_extra=extra)
print(json.dumps({{"correct": rec["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _top_modules_after(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=600,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                              "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax():
    got = _top_modules_after(RUN.format(
        root=str(ROOT), tests=str(BENCH / "tests"), name="mr-gradp.f32"))
    assert got["correct"]
    assert "porousfreezethaw_tpu_torch" in got["top"]
    assert not set(got["top"]) & set(harness.FORBIDDEN)


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "porousfreezethaw_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "porousfreezethaw_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "porousfreezethaw_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "porousfreezethaw_tpu.apps", sys)
    assert "porousfreezethaw_tpu" in harness.forbidden_modules()


REFERENCE_FILES = sorted(BENCH.glob("reference/*.py")) + sorted(
    BENCH.glob("configs/*.ref.py"))


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "numpy", "torch"}
    assert REFERENCE_FILES
    for path in REFERENCE_FILES:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)


def test_reference_runs_without_the_program():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        "from pathlib import Path\n"
        f"for p in {[str(p) for p in REFERENCE_FILES]!r}:\n"
        "    harness.load_module(Path(p))\n"
        "print(json.dumps({'top': sorted({m.split('.')[0] for m in "
        "sys.modules})}))\n")
    got = _top_modules_after(code)
    assert not set(got["top"]) & {"porousfreezethaw_tpu_torch",
                                  "porousfreezethaw_tpu", "jax"}
