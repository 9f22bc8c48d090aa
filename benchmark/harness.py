"""One run of one benchmark cell: set-up, the timed window, the traced
stretch (``--trace 1``), the comparison with the plain reference, and the
result line.

Everything that belongs to a cell is found by name:
``BENCHMARK.json`` names the cell's configuration (its ``file``) and
traffic mix; ``traffic/<traffic>.json`` holds the mix's settings;
``limits/<cell>.json`` the limits of the compared numbers;
``metrics/<metric>.py`` the reader of each metric; the configuration's
JSON names its system (``cases/<system>.py``), its plain reference
(``reference/<reference>.py``), its initial-condition formulas and its
work counts (``work/<work>.py``).  A new cell, configuration or metric is
new files and entries.

The window is the app's chunked solve (``merson_solve_device`` in calls of
the app's ``service_chunk()`` attempts, continued by ``between=``): it
starts at t = 0 after a warm-up call of one graph block (which captures
the graph) and ends at the first chunk boundary after ``seconds``.  At
each boundary the state and the control block are copied, so that one
chunk drawn from the seed can be followed by the reference afterwards.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# the glass-bead bed of every run: the app's default, the settled
# 200-sphere bed of data/spheres_positions.txt, as it is.  The seed does
# not turn or swap it: the same problem in another orientation takes
# another path through the step controller (0.9% of simulated time in a
# float64 window), and another bed another problem (a tenth at HR)
BED = "beds/spheres_positions.txt"

# what may not be loaded in the process that prints the result: compared
# by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "porousfreezethaw_tpu")


class BenchError(RuntimeError):
    pass


def load_module(path: Path):
    """Import the file ``path`` as a module of its own (once a path)."""
    name = "bench_" + "_".join(p.replace("-", "_").replace(".", "_")
                               for p in path.with_suffix("").parts[-2:])
    if name in sys.modules and getattr(sys.modules[name], "__file__",
                                       None) == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    config_dir: Path
    traffic: dict
    limits: dict
    metrics: list           # the metric entries this cell reports
    bench_dir: Path

    def read_text(self, rel: str) -> str:
        return (self.config_dir / rel).read_text()


def load_cell(name: str, spec: dict, bench_dir: Path = BENCH_DIR,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark ``spec`` (BENCHMARK.json)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in the benchmark")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg_path = root / cfg_entry["file"]
    cfg = json.loads(cfg_path.read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if reports(m) and m["moves"] in e2e_names]
    return Cell(name=name, chips=int(w["chips"]), config=cfg,
                config_dir=cfg_path.parent, traffic=traffic, limits=limits,
                metrics=[("end_to_end", m) for m in e2e]
                + [("per_layer", m) for m in per_layer],
                bench_dir=bench_dir)


# ----------------------------------------------------------------------
# the window
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Mark:
    """The solve at a chunk boundary: the state and the control block's
    values, and when (seconds into the window) it was taken."""

    y: torch.Tensor
    t: float
    h: float
    steps: int
    steps_total: int
    finished: bool
    at: float
    index: int
    steps_h: Optional[list] = None   # the h of each accepted step of the
                                     # chunk that ends here


def timed_window(sys_mod, case, device, seconds: float, frac: float,
                 keep: Optional[list] = None):
    """The app's chunked solve from t = 0 for ``seconds`` (to the next
    chunk boundary).  Returns (window record, (start mark, end mark) of
    the chunk drawn by ``frac``: the first chunk after the first that
    starts at or after ``frac * seconds``, else the last; the mark at the
    window's end).  The state is copied at each boundary until the drawn
    chunk has ended, so the copies alive are the same in every run.
    ``keep``, a list, receives the mark of every boundary instead (a
    survey of every chunk, ``sweep.py``; not the benchmark's runs)."""
    loop = sys_mod.device_loop(case, device)
    state = {"prev": Mark(case.y0, 0.0, case.tau, 0, 0, False, 0.0, 0),
             "drawn": None, "wall": 0.0, "chunks": 0}
    sync(device)
    t0 = time.perf_counter()

    def between(t_tr, h_tr, n_new, prev_steps):
        now = time.perf_counter() - t0
        state["wall"] = now
        state["chunks"] += 1
        if state["drawn"] is None or keep is not None:
            prev = state["prev"]
            c = loop.ctl.read()
            cur = Mark(loop.unpack(), c.t, c.h, int(c.steps),
                       int(c.steps_total), bool(c.finished), now,
                       prev.index + 1, h_tr[:n_new].tolist())
            if keep is not None:
                keep.append(cur)
                state["prev"] = cur
            elif (prev.index >= 1 and prev.at >= frac * seconds
                    or now >= seconds):
                state["drawn"] = (prev, cur)
            else:
                state["prev"] = cur
        return now >= seconds

    st, status = sys_mod.solve(case, case.y0, 0.0, case.tau, case.chunk,
                               between=between)
    if keep is not None:
        state["drawn"] = (keep[-2] if len(keep) > 1 else state["prev"],
                          keep[-1])
    if state["drawn"] is None:      # the solve reached its final time
        raise BenchError("the window outlasted the case's final time")
    end = Mark(st.y, st.t, st.h, st.steps, st.steps_total, False,
               state["wall"], state["chunks"])
    window = {"wall_s": end.at, "attempts": end.steps_total,
              "accepted": end.steps, "t_start": 0.0, "t_end": end.t,
              "chunks": end.index, "status": int(status),
              "cells": case.cells}
    return window, state["drawn"], end


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------------
# the comparison
# ----------------------------------------------------------------------

def _absolute(y: torch.Tensor, u_shift: float) -> torch.Tensor:
    """The (u, p, gl) planes of a program state in float64, u absolute."""
    out = y[:3].to(torch.float64).clone()
    if u_shift:
        out[0] += u_shift
    return out


def _field_gap(got: torch.Tensor, want: torch.Tensor, scale) -> float:
    """max over fields of max|got - want| / scale of the field (NaN
    propagates, so a non-finite state reads NaN)."""
    worst = 0.0
    for i in range(want.shape[0]):
        d = float(torch.amax(torch.abs(got[i] - want[i])))
        s = float(scale[i])
        gap = d / (s if s > 0 else 1.0)
        if math.isnan(gap):
            return gap
        worst = max(worst, gap)
    return worst


def start_gap(y0_prog: torch.Tensor, u_shift: float,
              y0_ref: torch.Tensor) -> float:
    """The program's initial state against the reference's, each field's
    largest difference over the field's largest magnitude."""
    got = _absolute(y0_prog, u_shift).to(y0_ref.device)
    scale = [torch.amax(torch.abs(y0_ref[i])) for i in range(3)]
    return _field_gap(got, y0_ref, scale)


def chunk_gaps(start: Mark, end: Mark, u_shift: float, replayed, delta,
               h_min, factor) -> dict:
    """The drawn chunk as the program ran it (``start`` to ``end``, its
    accepted steps ``end.steps_h``) against the reference's ``replayed``
    run of the same steps from the same start.

    - ``state_gap``: the state at the end, each field's largest difference
      over the field's largest change in the chunk (the attempt: the
      kernels or the plain right-hand side, and the commit);
    - ``eps_over_delta``: the largest reference error of an accepted step
      of at least ``h_min``, over delta (the accept rule);
    - ``h_overgrowth``: by how much h grew from one accepted step to the
      next beyond ``factor(eps)`` of the reference's error, at the most
      (the step rule; a rejection between two steps only shrinks h);
    - ``t_gap``: t at the end against the start plus the accepted steps
      (the commit of t)."""
    y_start = _absolute(start.y, u_shift).to(replayed.y.device)
    got = _absolute(end.y, u_shift).to(replayed.y.device)
    want = replayed.y.to(torch.float64)
    scale = []
    for i in range(3):
        moved = torch.amax(torch.abs(want[i] - y_start[i]))
        scale.append(moved if float(moved) > 0
                     else torch.amax(torch.abs(want[i])))
    hs = list(end.steps_h) + [end.h]
    eps = replayed.eps
    growth = 0.0
    for k, e in enumerate(eps):
        allowed = factor(e) * hs[k]
        if allowed == 0.0:
            # h = 0 (after an infinite error) grows to 0 only
            g = 1.0 if hs[k + 1] == 0.0 else math.inf
        else:
            g = hs[k + 1] / allowed
        growth = g if math.isnan(g) else max(growth, g)
    # a step under h_min is accepted whatever its error
    judged = [e for e, h in zip(eps, hs) if abs(h) >= h_min]
    worst_eps = max(judged, default=0.0)
    if any(math.isnan(e) for e in judged):
        worst_eps = math.nan
    advanced = sum(end.steps_h)
    return {"state_gap": _field_gap(got, want, scale),
            "eps_over_delta": worst_eps / delta,
            "h_overgrowth": (growth if math.isnan(growth)
                             else max(growth - 1.0, 0.0)),
            "t_gap": abs(end.t - start.t - advanced) / (advanced or 1.0)}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit at or under it (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)


def check_lines(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------

def seed_fraction(seed: int) -> float:
    """Where in the window the compared chunk is drawn, from the seed (the
    seed's one effect: every run solves the same case)."""
    return random.Random(seed).random()


def set_up(cell: Cell, device, workdir: Path,
           plant: Optional[Callable] = None, grid_extra: str = ""):
    """The cell's case built through the program, checked against the
    path and controller its traffic mix states, ``plant`` applied, and
    warmed up by one call of one graph block (which captures the graph):
    (system module, case, bed file)."""
    cfg, tr = cell.config, cell.traffic
    sys_mod = load_module(cell.bench_dir / "cases" / f"{cfg['system']}.py")
    bed_file = cell.bench_dir / BED
    text = sys_mod.params_text(cfg, tr, str(bed_file), cell.read_text,
                               grid_extra)
    case = sys_mod.build(text, tr["precision"], device, str(workdir))
    want_ctl = tr["controller"]
    got_ctl = {"accept_growth_min": case.mparams.accept_growth_min,
               "handle_nan": case.mparams.handle_nan}
    if case.path != tr["path"] or got_ctl != want_ctl:
        raise BenchError(
            f"{cell.name}: the program runs {case.path} with "
            f"{got_ctl}; the traffic mix states {tr['path']} with "
            f"{want_ctl}")
    if plant is not None:
        plant(case)
    warm = int(tr["warm_attempts"])
    sys_mod.solve(case, case.y0, 0.0, case.tau, warm)
    sync(device)
    return sys_mod, case, bed_file


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: torch.device, t_process: float,
             plant: Optional[Callable] = None, control: bool = False,
             grid_extra: str = "") -> dict:
    """One run of ``cell``; returns its record (``run.py`` makes the
    result line of it).  ``plant(case)`` breaks the program for a test;
    ``control`` also runs the lower-precision control in the program's
    place on the drawn chunk; ``grid_extra`` is Params text appended after
    the traffic's (a test's smaller grid)."""
    from . import profiling

    tr = cell.traffic
    workdir = Path(tempfile.mkdtemp(prefix="pft-bench-"))
    try:
        sys_mod, case, bed_file = set_up(cell, device, workdir, plant,
                                         grid_extra)
        loop = sys_mod.device_loop(case, device)
        setup_s = time.perf_counter() - t_process

        window, drawn, end = timed_window(sys_mod, case, device, seconds,
                                          seed_fraction(seed))
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

        traced = None
        if trace:
            traced = profiling.traced_stretch(
                lambda n: sys_mod.solve(case, end.y, end.t, end.h, n),
                int(tr["trace_attempts"]), sys_mod.counters(), device,
                workdir)

        rec = {
            "cell": cell.name, "seed": seed, "path": case.path,
            "setup_s": setup_s, "case_build_s": case.build_s,
            "graph_capture_s": loop.capture_s, "window": window,
            "trace": traced, "memory_peak_bytes": peak,
            "precision": tr["precision"],
            "work": work_counts(cell, case),
        }
        u_shift, y0_prog = case.u_shift, case.y0
        # the program's state and graph go before the reference runs
        case.attempt = loop = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        numbers, control_numbers = compare(cell, device, bed_file, u_shift,
                                           y0_prog, drawn, control)
        rec["check_s"] = time.perf_counter() - t_check
        hs = drawn[1].steps_h
        rec["drawn_chunk"] = {"index": drawn[0].index,
                              "t": drawn[0].t,
                              "attempts": drawn[1].steps_total
                              - drawn[0].steps_total,
                              "accepted": len(hs),
                              "h_smallest": min(hs, default=0.0),
                              "h_largest": max(hs, default=0.0)}
        rec["numbers"] = numbers
        rec["correct"] = verdict(numbers, cell.limits) and (
            window["status"] in (0, -7) and math.isfinite(window["t_end"]))
        if control_numbers is not None:
            rec["control"] = control_numbers
            rec["control_correct"] = verdict(control_numbers, cell.limits)
        return rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def compare(cell: Cell, device, bed_file, u_shift, y0_prog, drawn,
            control: bool):
    """The compared numbers of the program (and of the control, where
    asked): the start and the drawn chunk against the reference."""
    cfg, tr = cell.config, cell.traffic
    ref_mod = load_module(cell.bench_dir / "reference"
                          / f"{cfg['reference']}.py")
    icond = load_module(cell.config_dir / cfg["icond"]).icond
    ref = ref_mod.FreezingReference(cfg, device)
    y0_ref = ref.initial_state(icond, str(bed_file))
    start, end = drawn
    ctl = tr["controller"]
    delta = float(cfg["delta"])
    h_min = float(cfg["tau_min"])
    growth_min = float(ctl["accept_growth_min"])

    def factor(eps):
        return ref_mod.step_factor(eps, delta, growth_min)

    y_start = _absolute(start.y, u_shift)
    replayed = ref.replay(y_start, start.t, end.steps_h)
    numbers = {"start_gap": start_gap(y0_prog, u_shift, y0_ref),
               **chunk_gaps(start, end, u_shift, replayed, delta, h_min,
                            factor)}
    control_numbers = None
    if control:
        # the reference in the next lower width in the program's place:
        # its own run of the chunk's attempts from the same start
        low = getattr(torch, tr["control_dtype"])
        cref = ref_mod.FreezingReference(cfg, device, dtype=low)
        cf = cref.follow(y_start, t=start.t, h=start.h,
                         tf=float(cfg["final_time"]),
                         attempts=end.steps_total - start.steps_total,
                         delta=delta, h_min=h_min,
                         growth_min=growth_min,
                         handle_nan=bool(ctl["handle_nan"]),
                         finished=start.finished)
        c_end = Mark(cf.y, cf.t, cf.h, start.steps + cf.accepted,
                     start.steps_total + cf.attempts, cf.finished, 0.0,
                     end.index, cf.steps_h)
        c_rep = ref.replay(y_start, start.t, cf.steps_h)
        control_numbers = {
            "start_gap": start_gap(y0_ref.to(low), 0.0, y0_ref),
            **chunk_gaps(start, c_end, 0.0, c_rep, delta, h_min, factor)}
    return numbers, control_numbers


def work_counts(cell: Cell, case) -> dict:
    work = load_module(cell.bench_dir / "work" / f"{cell.config['work']}.py")
    itemsize = torch.empty((), dtype=case.dtype).element_size()
    return {"bytes_per_attempt": work.attempt_bytes(case.cells, itemsize),
            "ops_per_attempt": work.attempt_ops(case.cells,
                                                int(cell.config["calc_mode"])),
            "dtype": str(case.dtype).replace("torch.", "")}


# ----------------------------------------------------------------------
# the result
# ----------------------------------------------------------------------

def metric_values(cell: Cell, rec: dict, trace: bool, peaks: dict) -> dict:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones,
    each read by ``metrics/<name>.py``; a reader that finds nothing to
    read returns None and the metric is left out."""
    kind = "per_layer" if trace else "end_to_end"
    out = {}
    for k, m in cell.metrics:
        if k != kind:
            continue
        reader = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py")
        v = reader.read(rec, peaks)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def kernel_lines(cell: Cell, rec: dict, peaks: dict) -> list:
    """One line for each kernel of the traced window: launches, device
    seconds, the mean launch, and for the program's stage and commit
    kernels the share of their bytes bound (``work/``)."""
    work = load_module(cell.bench_dir / "work" / f"{cell.config['work']}.py")
    tr = rec["trace"]
    peak = peaks.get(rec.get("device_kind", ""), {})
    itemsize = 8 if rec["work"]["dtype"] == "float64" else 4
    lines = []
    for name, n in sorted(tr["launch_counts"].items(),
                          key=lambda kv: -tr["kernel_s"][kv[0]]):
        s = tr["kernel_s"][name]
        line = (f"kernel launches {n} device_s {s!r} mean_us "
                f"{1e6 * s / n!r}")
        nbytes = work.kernel_bytes(name, rec["window"]["cells"], itemsize)
        if nbytes and peak:
            share = 100.0 * nbytes / peak["bytes_per_s"] / (s / n)
            line += f" bytes_bound_pct {share!r}"
        lines.append(f"{line} name {name[:160]}")
    return lines
