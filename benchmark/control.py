"""The control of a cell's comparison: for each seed, one run of the cell
whose drawn chunk is also run by the plain reference in the next lower
width (the traffic mix's ``control_dtype``: bfloat16 for float32 cells,
float32 for float64 ones) put in the program's place, and judged alike.
Prints one JSON line a seed with the program's numbers, the control's and
the limits; the control has to fail at least one limit.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds 20

The benchmark's own runs do not run it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    from benchmark.run import fixed_caches

    fixed_caches()
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, spec)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = harness.run_cell(cell, seed, args.seconds, False,
                               device=torch.device("cuda", 0),
                               t_process=t0, control=True)
        failed_all &= not rec["control_correct"]
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "program": rec["numbers"], "correct": rec["correct"],
            "control": rec["control"],
            "control_correct": rec["control_correct"],
            "limits": cell.limits, "drawn_chunk": rec["drawn_chunk"],
            "check_s": rec["check_s"], "setup_s": rec["setup_s"],
            "window": rec["window"],
            "run_s": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
