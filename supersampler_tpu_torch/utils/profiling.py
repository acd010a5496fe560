"""Phase timers + optional device tracing.

The port's copy of supersampler_tpu/utils/profiling.py:

* ``timers`` — a process-wide, thread-safe accumulator of named
  wall-clock spans (``with phase("prep"): ...``); ``report()`` renders
  totals, ``reset()`` clears them.
* ``device_trace`` — runs a region under ``torch.profiler`` (CPU and,
  where there is a card, CUDA activities) when the SPSP_TRACE env var
  names a directory, and writes a Chrome trace to
  ``$SPSP_TRACE/<label>.json``; a no-op otherwise, so production paths
  pay nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

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


timers = PhaseTimers()
phase = timers.phase


@contextlib.contextmanager
def device_trace(label: str = "spsp"):
    """torch.profiler trace into $SPSP_TRACE/<label>.json when set."""
    out = os.environ.get("SPSP_TRACE")
    if not out:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"{label}.json"))
