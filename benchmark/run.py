"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, on a machine with
the CUDA cards the cell asks for.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
compared number beside its limit, which also end standard error.  Exits
non-zero with no result without the cards, or when JAX or the JAX package
was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's kernels build into its own ``build/kernels``)."""
    for var, rel in (("TRITON_CACHE_DIR", "build/triton"),
                     ("TORCH_EXTENSIONS_DIR", "build/torch_extensions")):
        os.environ[var] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "porousfreezethaw_tpu_torch").is_dir():
        print(f"no program under test beside the benchmark in {ROOT}",
              file=sys.stderr)
        return 2
    fixed_caches()
    sys.path.insert(0, str(ROOT))

    import torch
    from benchmark import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, spec)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rec = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device=device, t_process=T_PROCESS)

    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the result's process: {', '.join(found)}",
              file=sys.stderr)
        return 3

    kind = torch.cuda.get_device_name(device)
    rec["device_kind"] = kind
    peaks = json.loads((ROOT / "benchmark" / "peaks.json").read_text())
    metrics = harness.metric_values(cell, rec, bool(args.trace), peaks)
    w = rec["window"]
    out = {
        "correct": rec["correct"],
        "attempted": w["attempts"],
        "failed": 0 if w["status"] in (0, -7) else w["attempts"],
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": rec["memory_peak_bytes"],
                   "power_limit": power_limit()},
    }
    tr = rec["trace"]
    if tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        for line in harness.kernel_lines(cell, rec, peaks):
            print(line)
    print(json.dumps({"run": {k: rec[k] for k in (
        "cell", "seed", "path", "drawn_chunk", "numbers")},
        "window": w, "setup_s": rec["setup_s"], "check_s": rec["check_s"]}))
    check = harness.check_lines(rec["numbers"], cell.limits)
    out["check"] = check
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
