"""The traced stretch of a ``--trace 1`` run and its reduction: device
busy time as the union of the device's operation intervals inside the
traced window, kernel launches checked against the program's own
counters, the device operations that took most time, and the idle gaps
by what the host was doing.

A trace may lose kernel records of a run that launched them (torch's
profiler did so in about one trace of twelve on the card).  As the
program's ``chip_smoke.py`` ``_traced_run`` does, a trace that holds fewer
launches of the program's kernels than their counters added is taken
again, up to ``PROFILE_TRIES`` traces; more than counted, or no trace
that agrees, is an error.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

import torch

PROFILE_TRIES = 3
WINDOW = "bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


class TraceError(RuntimeError):
    pass


def _count(counters) -> dict:
    return {name: sum(getattr(o, a) for o, a in pairs)
            for name, pairs in counters}


def traced_stretch(run, attempts: int, counters, device: torch.device,
                   workdir: Path) -> dict:
    """``run(attempts)`` under torch.profiler; returns the reduction of
    the first trace whose launches agree with ``counters`` ((kernel name,
    [(object, attribute), ...]) pairs)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    lost = []
    for k in range(PROFILE_TRIES):
        before = _count(counters)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                run(attempts)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        counted = {n: v - before[n] for n, v in _count(counters).items()}
        path = Path(workdir) / f"trace{k}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        rec = reduce_events(events)
        if device.type != "cuda":
            rec.update(attempts=attempts, traces_lost=lost, counted=counted)
            return rec
        if rec["busy_s"] <= 0:
            raise TraceError("the profiler recorded no device time")
        got = {n: sum(c for name, c in rec["launch_counts"].items()
                      if n in name) for n in counted}
        if got == counted:
            rec.update(attempts=attempts, traces_lost=lost,
                       counted=counted)
            return rec
        if any(got[n] > counted[n] for n in counted):
            raise TraceError(f"traced launches {got}, counted {counted}")
        lost.append(got)
    raise TraceError(f"traced launches {lost}, counted {counted} in each "
                     f"of {PROFILE_TRIES} traces")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events) -> dict:
    """The traced window's figures from Chrome-trace events (times in
    microseconds there, seconds here)."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW and e.get("ph") == "X"]
    if not win:
        raise TraceError(f"no {WINDOW} span in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    by_name = defaultdict(float)
    launches = defaultdict(int)
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] += b - a
        if cat == "kernel":
            launches[e["name"]] += 1
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps[_host_at(host, starts, 0.5 * (edge + a))] += a - edge
        edge = max(edge, b)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "launches": sum(launches.values()),
        "launch_counts": dict(launches),
        "kernel_s": {n: s * 1e-6 for n, s in by_name.items()},
        "device_ops": [[n, s * 1e-6] for n, s in top_ops],
        "idle_gaps": [[n, s * 1e-6] for n, s in top_gaps],
    }


def _host_at(host, starts, t: float) -> str:
    """The innermost host call running at ``t`` (the latest to start of
    those that cover it)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 200, -1), -1):
        a, b, name = host[j]
        if a <= t <= b:
            return name
    return "host outside traced calls"
