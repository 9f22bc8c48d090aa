"""Run logging: the memstream-buffered main log and the RK debug log.

* :class:`RunLog` mirrors ``mprintf``'s MEMSTREAM + rank-0 console
  printing (``modules/mprintf/mprintf.c``, ``intertrack.c:160-201``): the
  whole log is buffered in memory and committed incrementally to disk at
  >= 3 s intervals, so a crashed run still has a current tail on disk.

* :class:`RKDebugLog` writes the reference's per-successful-step solver
  trace (``RKService``, ``intertrack.c:1072-1107``): timestamp, step
  number, t, tau, elapsed time, estimated time to the next snapshot and to
  completion.  It is wired into the Merson solver's service callback.

* :func:`format_time` is the reference's H:MM:SS.ss formatter
  (``intertrack.c:1040-1058``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional


def format_time(seconds: float) -> str:
    if seconds < 0:
        seconds = 0.0
    if seconds > 31536000.0:
        return "[> 1 year]"
    minutes = int(math.floor(seconds / 60))
    hours = minutes // 60
    seconds -= 60 * minutes
    minutes -= 60 * hours
    return f"{hours}:{minutes:02d}:{seconds:05.2f}"


def format_date(t: Optional[float] = None) -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(time.time() if t is None else t))


class RunLog:
    """Memory-buffered log with periodic disk commit + console echo."""

    COMMIT_INTERVAL = 3.0  # seconds (intertrack.c:165)

    def __init__(self, path: str = "", echo: bool = True):
        self.path = path
        self.echo = echo
        self.buffer: list[str] = []
        self._last_commit = 0.0
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # truncate at start of run
            with open(path, "w"):
                pass

    def write(self, text: str) -> None:
        self.buffer.append(text)
        if self.echo:
            print(text, end="", flush=True)
        now = time.time()
        if self.path and now - self._last_commit >= self.COMMIT_INTERVAL:
            self.commit()

    def __call__(self, fmt: str, *args) -> None:
        self.write(fmt % args if args else fmt)

    def commit(self) -> None:
        if self.path:
            with open(self.path, "w") as f:
                f.write("".join(self.buffer))
            self._last_commit = time.time()

    def close(self) -> None:
        self.commit()


class RKDebugLog:
    """Per-successful-step RK trace file (the 'set debug_logfile' feature)."""

    def __init__(self, path: str, final_time: float, starting_time: float = 0.0):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.f = open(path, "w", buffering=1)
        self.final_time = final_time
        self.starting_time = starting_time
        self.wall_start = time.time()
        self.snapshot = 0
        self.snapshot_time = 0.0

    def set_snapshot(self, snapshot: int, snapshot_time: float) -> None:
        self.snapshot = snapshot
        self.snapshot_time = snapshot_time

    def log_step(self, t: float, tau: float, steps: int) -> None:
        elapsed = time.time() - self.wall_start
        prog = t - self.starting_time
        if prog > 0:
            eta_snap = elapsed * ((self.snapshot_time - self.starting_time) / prog - 1.0)
            eta_done = elapsed * ((self.final_time - self.starting_time) / prog - 1.0)
        else:
            eta_snap = eta_done = float("inf")
        self.f.write(
            f"{format_date()} - step {steps:08d}, t={t:10.4E}, "
            f"tau={tau:10.4E}, Elapsed time: {format_time(elapsed)}, "
            f"Est. time to snapshot {self.snapshot} "
            f"(t={self.snapshot_time:10.4E}): {format_time(min(eta_snap, 1e9))}, "
            f"Est. time to final t={self.final_time:10.4E}): "
            f"{format_time(min(eta_done, 1e9))}\n")

    def close(self) -> None:
        self.f.close()
