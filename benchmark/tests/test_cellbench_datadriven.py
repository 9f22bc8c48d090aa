"""A later cell needs only data: a copy of the benchmark's folder in a
temporary directory, with a new traffic mix, a new configuration (its
Params text, its initial-condition formulas) and a new cell added as
files and entries, runs through the harness unchanged."""

import json
import shutil

from cellbench_tiny import BENCH, run_tiny, spec


def test_new_cell_from_data_files(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    s = spec()
    # a new configuration: the MR GradP case in calc mode 1 (SigmaP1-P)
    cfg = json.loads((bench / "configs" / "intertrack-mr-gradp.json")
                     .read_text())
    text = (bench / "configs" / "intertrack-mr-gradp.params.txt").read_text()
    (bench / "configs" / "mr-sigmap.params.txt").write_text(
        text + "calc_mode 1\n")
    shutil.copy(bench / "configs" / "intertrack-mr-gradp.ref.py",
                bench / "configs" / "mr-sigmap.ref.py")
    cfg.update(name="mr-sigmap", calc_mode=1,
               params_text="mr-sigmap.params.txt", icond="mr-sigmap.ref.py")
    (bench / "configs" / "mr-sigmap.json").write_text(json.dumps(cfg))
    s["configs"].append({"name": "mr-sigmap", "source": "test",
                         "file": "benchmark/configs/mr-sigmap.json",
                         "reduced": [], "why": "test"})
    # a new traffic mix: the compensated commit
    tr = json.loads((bench / "traffic" / "f32.json").read_text())
    tr.update(params={"increment_form": 1, "compensated_commit": 1},
              path="DeltaAttemptComp")
    (bench / "traffic" / "f32-comp.json").write_text(json.dumps(tr))
    s["workloads"].append({"name": "mr-sigmap.f32-comp",
                           "config": "mr-sigmap", "traffic": "f32-comp",
                           "chips": 1, "why": "test"})
    shutil.copy(bench / "limits" / "mr-gradp.f32.json",
                bench / "limits" / "mr-sigmap.f32-comp.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    rec = run_tiny("mr-sigmap.f32-comp", monkeypatch, spec_=s,
                   bench_dir=bench, root=tmp_path)
    assert rec["path"] == "DeltaAttemptComp"
    assert rec["correct"], rec["numbers"]
    assert rec["window"]["attempts"] > 0
