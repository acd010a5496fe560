"""Phase timers, spans and counters, and the optional device trace.

The port's copy of supersampler_tpu/utils/profiling.py, grown into the
port's one tracer:

* ``timers`` — a process-wide, thread-safe accumulator of named
  wall-clock phases (``with phase("prep"): ...``); ``report()`` renders
  totals, ``reset()`` clears them. The totals and counts always fill.
* While a ``torch.profiler`` session is active in the process (any
  thread's: torch's own process-wide flag, which worker threads see
  too), each phase is also a span, ``Span(name, t0, t1, thread, span,
  parent, call)`` on ``time.perf_counter``: the parent is the phase
  open around it on the same thread, and the call id is the span id of
  the outermost one, so the spans of one comparison share it. Each
  such phase also opens a profiler range inside its span,
  which puts it on the profiler's own clock, in its Chrome trace.
  ``count(name, n)`` records a counter with the open span's call id,
  in a session only. ``spans()`` and ``counters()`` read them out; the
  buffer keeps the first ``cap`` of each and counts the rest in
  ``dropped``.
* ``device_trace`` — runs a region under ``torch.profiler`` (CPU and,
  where there is a card, CUDA activities) when the SPSP_TRACE env var
  names a directory, and writes a Chrome trace to
  ``$SPSP_TRACE/<label>.json``; a no-op otherwise, so production paths
  pay nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler

# The fast form of a record_function range, which torch's compiled
# kernels open theirs with: 0.4-1.8 us a range against 9-13 us on an
# H100's host. It shows in the Chrome trace as a CPU op.
_range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    thread: int
    span: int
    parent: Optional[int]
    call: int


class Count(NamedTuple):
    name: str
    n: int
    t: float
    thread: int
    call: Optional[int]


class PhaseTimers:
    def __init__(self, cap: int = 1 << 18):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.cap = cap
        self.dropped = 0
        self._spans: List[Span] = []
        self._counters: List[Count] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        """This thread's open traced phases, (span id, call id) each."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, buf: list, rec) -> None:
        # under self._lock
        if len(buf) < self.cap:
            buf.append(rec)
        else:
            self.dropped += 1

    def _add(self, name: str, dt: float, span: Optional[Span]) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if span is not None:
                self._keep(self._spans, span)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not _torch_profiler._is_profiler_enabled:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0, None)
            return
        stack = self._stack()
        sid = next(self._ids)
        parent, call = stack[-1] if stack else (None, sid)
        stack.append((sid, call))
        t0 = time.perf_counter()
        try:
            with _range(name):
                yield
        finally:
            t1 = time.perf_counter()
            stack.pop()
            self._add(name, t1 - t0,
                      Span(name, t0, t1, threading.get_ident(), sid, parent,
                           call))

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter name, in a profiler session only."""
        if not _torch_profiler._is_profiler_enabled:
            return
        stack = self._stack()
        rec = Count(name, int(n), time.perf_counter(),
                    threading.get_ident(), stack[-1][1] if stack else None)
        with self._lock:
            self._keep(self._counters, rec)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def counters(self) -> List[Count]:
        with self._lock:
            return list(self._counters)

    def report(self) -> str:
        with self._lock:
            rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
            return "\n".join(
                f"{name:24s} {tot * 1e3:10.1f} ms  x{self.counts[name]}"
                for name, tot in rows)

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self._spans.clear()
            self._counters.clear()
            self.dropped = 0


timers = PhaseTimers()
phase = timers.phase
count = timers.count


@contextlib.contextmanager
def device_trace(label: str = "spsp"):
    """torch.profiler trace into $SPSP_TRACE/<label>.json when set."""
    out = os.environ.get("SPSP_TRACE")
    if not out:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"{label}.json"))
