"""The harness picks the attempt class that the app picks: for each
cell's Params and precision at a tiny grid, the app's log on the CPU
names the same path as the harness's set-up."""

import os
import re

import pytest
import torch

from cellbench_tiny import ROOT, grid_text, spec

from benchmark import harness

CELLS = [w["name"] for w in spec()["workloads"]]

# the app's log line of each attempt class (apps/intertrack.py)
LOG = {"DeltaAttempt": r"Increment-form \(delta\) attempt kernels: ON \(",
       "DeltaAttemptComp": r"Increment-form \(delta\) attempt kernels: ON "
                           r"\(compensated commit\)",
       "StageAttempt": r"Fused stage kernel: ON"}


def _app_path(log: str) -> str:
    for path, pat in (("DeltaAttemptComp", LOG["DeltaAttemptComp"]),
                      ("DeltaAttempt", LOG["DeltaAttempt"]),
                      ("StageAttempt", LOG["StageAttempt"])):
        if re.search(pat, log):
            return path
    return "PlainAttempt"


@pytest.mark.parametrize("name", CELLS)
def test_harness_picks_the_apps_path(name, tmp_path):
    from porousfreezethaw_tpu_torch.apps import intertrack
    cell = harness.load_cell(name, spec())
    sys_mod = harness.load_module(cell.bench_dir / "cases"
                                  / f"{cell.config['system']}.py")
    bed = cell.bench_dir / harness.BED
    text = sys_mod.params_text(cell.config, cell.traffic, str(bed),
                               cell.read_text, grid_text(8))
    case = sys_mod.build(text, cell.traffic["precision"],
                         torch.device("cpu"), str(tmp_path))
    assert case.path == cell.traffic["path"]

    params = tmp_path / "Params"
    params.write_text(text + "final_time 0.5\nsaved_files 2\n")
    os.environ["OUTPUT"] = str(tmp_path)
    try:
        rc = intertrack.main([str(params), "--precision",
                              cell.traffic["precision"], "--device", "cpu"])
    finally:
        del os.environ["OUTPUT"]
    assert rc == 0
    log = (tmp_path / "intertrack.log").read_text()
    assert _app_path(log) == case.path


CONFIGS = sorted({c["name"]: c["file"] for c in spec()["configs"]}.items())


@pytest.mark.parametrize("name,file", CONFIGS)
def test_config_json_is_the_params_text(name, file, tmp_path):
    """The reference's constants (the configuration's JSON) are the
    program's reading of the Params text."""
    import json
    from porousfreezethaw_tpu_torch.config.params import parse_param_file
    from porousfreezethaw_tpu_torch.models.freezing.parameters import (
        PARAM_NAMES)
    cfg = json.loads((ROOT / file).read_text())
    text = (ROOT / file).parent.joinpath(cfg["params_text"]).read_text()
    pf = parse_param_file(text, env={"OUTPUT": str(tmp_path)})
    assert {n: pf.get(n) for n in PARAM_NAMES} == cfg["physics"]
    assert {k: pf.get(k) for k in cfg["grid"]} == cfg["grid"]
    for k in ("calc_mode", "delta", "tau", "tau_min", "final_time"):
        assert pf.get(k) == cfg[k], k
    assert cfg["reduced"] == []
