"""A survey of every chunk that a run of a cell can draw: the timed
window once, the state kept at every chunk boundary, and each chunk
(every ``--every``-th from ``--first``, by default the second, the
first that a run can draw) compared with the plain reference
as a run compares its drawn chunk.  Prints one JSON line a chunk.

    python3 benchmark/sweep.py --workload <name> --seconds 20 \\
        [--first 1] [--every 2] [--witness 2]

``--witness k`` also prints, for the steps of chunk k where the
reference's error is largest, each step's h, that error and the bound on
the program's own error that its next h implies: delta (0.8 h /
h_next)^5, equal where no attempt was rejected between the two steps.
The benchmark's own runs do not run it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def witness(cell, ref_mod, device, u_shift, start, end, top=12):
    """Per-step errors of chunk (start, end): the reference's and the
    program's implied."""
    from benchmark import harness

    cfg = cell.config
    delta = float(cfg["delta"])
    y_start = harness._absolute(start.y, u_shift)
    hs = list(end.steps_h)
    eps = ref_mod.FreezingReference(cfg, device).replay(
        y_start, start.t, hs).eps
    nxt = hs[1:] + [end.h]
    implied = [delta * (0.8 * h / n) ** 5 if n else float("nan")
               for h, n in zip(hs, nxt)]
    order = sorted(range(len(hs)), key=lambda k: -eps[k])[:top]
    rows = [{"step": k, "h": hs[k], "eps": eps[k] / delta,
             "program_at_most": implied[k] / delta} for k in sorted(order)]
    return {"witness_chunk": start.index, "steps": len(hs),
            "over_delta": sum(e > delta for e in eps), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--witness", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    from benchmark.run import fixed_caches

    fixed_caches()
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, spec)
    workdir = Path(tempfile.mkdtemp(prefix="pft-sweep-"))
    try:
        sys_mod, case, bed_file = harness.set_up(cell, device, workdir)
        marks = []
        window, _, _ = harness.timed_window(sys_mod, case, device,
                                            args.seconds, 0.0, keep=marks)
        u_shift, y0_prog = case.u_shift, case.y0
        case.attempt = None
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "window": window}),
              flush=True)
        ref_mod = harness.load_module(
            cell.bench_dir / "reference" / f"{cell.config['reference']}.py")
        for i in range(1, len(marks)):
            start, end = marks[i - 1], marks[i]
            if start.index != args.witness and (
                    start.index < args.first
                    or (start.index - args.first) % args.every):
                continue
            t0 = time.perf_counter()
            numbers, _ = harness.compare(cell, device, bed_file, u_shift,
                                         y0_prog, (start, end), False)
            line = {"workload": cell.name, "chunk": start.index,
                    "t": start.t, "attempts": end.steps_total
                    - start.steps_total, "accepted": len(end.steps_h),
                    "h_largest": max(end.steps_h, default=0.0),
                    "numbers": numbers,
                    "correct": harness.verdict(numbers, cell.limits),
                    "check_s": time.perf_counter() - t0}
            if start.index == args.witness:
                line["witness"] = witness(cell, ref_mod, device, u_shift,
                                          start, end)
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
