"""Helpers of the benchmark's CPU tests: a cell of ``BENCHMARK.json`` run
through the harness at a tiny grid on the CPU (the program's kernels
compute with their plain versions there)."""

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def grid_text(nodes: int) -> str:
    """Params lines that put ``nodes`` cells along the long side."""
    return (f"grid_nodes {nodes}\nmultiplier grid_nodes / (L1 max L2 max "
            "L3)\nn1 L1 * multiplier\nn2 L2 * multiplier\nn3 L3 * "
            "multiplier\n")


def tiny(cell, nodes: int = 8):
    """``cell`` with its reference's grid cut to ``nodes`` along z (the
    domain is 1 x 1 x 2), and the Params lines that cut the program's."""
    g = dict(cell.config["grid"], n1=nodes // 2, n2=nodes // 2, n3=nodes)
    cell.config = dict(cell.config, grid=g)
    return cell, grid_text(nodes)


def run_tiny(name, monkeypatch, *, seed=20261018, seconds=0.3, chunk=32,
             spec_=None, bench_dir=BENCH, root=ROOT, **kw):
    """One run of cell ``name`` at a tiny grid on the CPU, chunks of
    ``chunk`` attempts; returns the harness's record."""
    from benchmark import harness
    monkeypatch.setenv("PFT_SERVICE_CHUNK", str(chunk))
    cell = harness.load_cell(name, spec_ or spec(), bench_dir, root)
    cell, extra = tiny(cell)
    return harness.run_cell(cell, seed, seconds, False,
                            device=torch.device("cpu"),
                            t_process=time.perf_counter(),
                            grid_extra=extra, **kw)
