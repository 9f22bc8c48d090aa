"""In-memory spans of the port's set-up phases and of its device loop.

A span is a name, its start and end on ``time.perf_counter_ns``, the id
of the span open around it (``parent``), the id of its root and a small
dict of attributes.  Spans of one solve call share the id of their root,
the ``pft.solve`` span.  They go, as they close, into one bounded store
(``spans()``, ``clear()``).

    with tracing.span("pft.loop.capture") as sp:
        ...
    sp.seconds            # its duration

``span`` also decorates a function.  While a torch.profiler session
records, each span also opens ``torch.profiler.record_function`` of its
name, so it appears in the profiler's Chrome trace as a
``user_annotation`` event on the profiler's clock, beside the kernels it
caused.

Two tiers.  Cold spans (set-up phases, a solve call and its begin,
capture, chunk and unpack) are recorded always: a few per chunk of
attempts, each a couple of microseconds.  Hot instrumentation (a span per
graph block of the device loop, its replay and read-back, and CUDA events
around each replay) is for the code that checks ``hot()``: true while a
torch.profiler session records or inside ``recording()``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Optional

import torch

# a 10-hour MR run makes about 2,000 solve chunks of a few cold spans each
STORE_LEN = 10_000


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: Optional[int] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        """The duration (the span has closed)."""
        return (self.end_ns - self.start_ns) * 1e-9


_store: collections.deque = collections.deque(maxlen=STORE_LEN)
_open: list = []          # the spans open now, innermost last
_ids = itertools.count(1)
_recording = 0


def spans() -> list:
    """The recorded spans, in the order they closed (children before
    their parent), the oldest dropped past ``STORE_LEN``."""
    return list(_store)


def clear() -> None:
    _store.clear()


def _profiling() -> bool:
    """Whether a torch.profiler session records."""
    return torch.autograd._profiler_enabled()


def hot() -> bool:
    """Whether the hot instrumentation runs: under a recording
    torch.profiler session, or inside ``recording()``."""
    return _recording > 0 or _profiling()


@contextlib.contextmanager
def recording():
    """Turn the hot instrumentation on for the block, without a
    profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost open span (the one a decorated
    function runs in)."""
    if _open:
        _open[-1].attrs.update(attrs)


@contextlib.contextmanager
def span(name: str, *, root: bool = False, **attrs):
    """Record the block as the span ``name`` with ``attrs`` (the yielded
    span's ``attrs`` take more while it is open).  ``root`` starts a new
    root id: its own, shared by the spans inside it."""
    # the profiler's range opens first and closes last, so that it covers
    # the span's own bookkeeping too
    annotation = None
    if _profiling():
        annotation = torch.profiler.record_function(name)
        annotation.__enter__()
    parent = _open[-1] if _open else None
    sid = next(_ids)
    sp = Span(name, sid, None if parent is None else parent.id,
              sid if root or parent is None else parent.root,
              time.perf_counter_ns(), attrs=attrs)
    _open.append(sp)
    try:
        yield sp
    finally:
        sp.end_ns = time.perf_counter_ns()
        _open.pop()
        _store.append(sp)
        if annotation is not None:
            annotation.__exit__(None, None, None)
