"""Faults planted under a cell's timed path, and their readings.

Each fault is a function ``plant(case)`` that breaks the program's solve
of one case before its warm-up (so the captured graph holds the fault):

- ``unchanged``: every step returns its state unchanged (t and h still
  advance);
- ``half``: the upper half of the z planes left out of every update;
- ``half_rows``: every other y row left out of every update (half of the
  cells, in every part of the domain);
- ``altered``: one answer altered where it is produced: the temperature
  of one cell moved by 1 K at every commit;
- ``loose_accept``: the step controller accepts, and sizes the next step,
  against 4 delta instead of delta (``loose_accept_8``, ``loose_accept_16``:
  8 and 16 delta);
- ``t_drift``: the committed t advances 1% more than the accepted step.

A probe, run like a fault but not a fault every comparison can see:
``half_lower``, the lower half of the z planes left out of every update,
the half that the cooling from the top reaches last.

    python3 benchmark/faults.py --workload <name> --faults half,t_drift \\
        --seeds 1,2,3 --seconds 20

runs the cell once for each fault and seed on the card and prints one
JSON line each with the compared numbers and the limits.  The
benchmark's own runs do not run it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _state(b):
    return b.get("leaves", b["y"])


def _wrap(case, before, after):
    """Run ``before(ctl, b)`` (its result handed on) and ``after(ctl, b,
    kept)`` around each attempt of ``case``."""
    orig = case.attempt._dev_attempt

    def attempt(ctl, b):
        kept = before(ctl, b)
        orig(ctl, b)
        after(ctl, b, kept)
    case.attempt._dev_attempt = attempt


def unchanged(case):
    _wrap(case, lambda ctl, b: b["y"].clone(),
          lambda ctl, b, kept: b["y"].copy_(kept))


def half(case):
    def part(b):
        y = _state(b)
        return y[:, y.shape[1] // 2:]
    _wrap(case, lambda ctl, b: part(b).clone(),
          lambda ctl, b, kept: part(b).copy_(kept))


def half_rows(case):
    def part(b):
        return _state(b)[:, :, ::2]
    _wrap(case, lambda ctl, b: part(b).clone(),
          lambda ctl, b, kept: part(b).copy_(kept))


def half_lower(case):
    def part(b):
        y = _state(b)
        return y[:, :y.shape[1] // 2]
    _wrap(case, lambda ctl, b: part(b).clone(),
          lambda ctl, b, kept: part(b).copy_(kept))


def altered(case):
    def after(ctl, b, kept):
        _state(b)[0, 1, 1, 1] += 1.0
    _wrap(case, lambda ctl, b: None, after)


def _loose(factor):
    def plant(case):
        case.mparams = dataclasses.replace(
            case.mparams, delta=factor * case.mparams.delta)
    return plant


loose_accept, loose_accept_8, loose_accept_16 = (_loose(f)
                                                 for f in (4.0, 8.0, 16.0))


def _t_view(ctl):
    """The control block's t (its first field, a double) as a tensor."""
    import torch
    return ctl.buf[:8].view(torch.float64)


def t_drift(case):
    def after(ctl, b, kept):
        t = _t_view(ctl)
        t.add_((t - kept) * 0.01)
    _wrap(case, lambda ctl, b: _t_view(ctl).clone(), after)


FAULTS = {"unchanged": unchanged, "half": half, "half_rows": half_rows,
          "altered": altered, "loose_accept": loose_accept,
          "loose_accept_8": loose_accept_8,
          "loose_accept_16": loose_accept_16, "t_drift": t_drift}
PROBES = {"half_lower": half_lower}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--faults", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    from benchmark.run import fixed_caches

    fixed_caches()
    if not torch.cuda.is_available():
        print("faults.py needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, spec)
    caught_all = True
    for name in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            rec = harness.run_cell(cell, seed, args.seconds, False,
                                   device=torch.device("cuda", 0),
                                   t_process=t0,
                                   plant={**FAULTS, **PROBES}[name])
            caught_all &= not rec["correct"]
            print(json.dumps({
                "workload": cell.name, "fault": name, "seed": seed,
                "numbers": rec["numbers"], "correct": rec["correct"],
                "limits": cell.limits, "drawn_chunk": rec["drawn_chunk"],
                "window": rec["window"],
                "run_s": time.perf_counter() - t0}), flush=True)
    return 0 if caught_all else 1


if __name__ == "__main__":
    sys.exit(main())
