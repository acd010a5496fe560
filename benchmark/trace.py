"""What a traced run reads: the device's operations from torch.profiler
(CUPTI), host spans, and the program's kernel launches.

* Device operations: kernels, copies and sets, placed on the host's
  clock by a marker kernel launched just before the window. Their union
  is the busy time (the merge of chip_profile.py ``device_events``).
* Host spans: the program's own phases (``phase`` of
  utils/profiling.py, wrapped where the sketch path and the FASTA
  reader call it) and the spans the entries record around the calls
  they make. They name the host's work during each idle gap.
* Launches: the scan kernels' arguments at each launch
  (``ops/_build.launch``), in launch order, for their rooflines.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Trace:
    def __init__(self, device):
        self.device = device
        self.spans = []           # (name, t0, t1) on perf_counter
        self.launches = []        # (entry name, P, P_rec)
        self.events = []          # (t0, t1, name), host clock
        self._prof = None
        self._undo = []
        self.on = False           # instrumented, the window under way

    # ---- instrumentation of the program, for this run only ----
    def _patch(self, module, attr, new):
        old = getattr(module, attr)
        setattr(module, attr, new)
        self._undo.append((module, attr, old))

    def instrument(self, entry) -> None:
        """Record the program's phases and scan launches, and the
        entry's own spans, until ``stop``."""
        self.on = True
        if hasattr(entry, "instrument"):
            entry.instrument(self)
        from supersampler_tpu_torch.io import fasta
        from supersampler_tpu_torch.ops import _build
        from supersampler_tpu_torch.sketch import pipeline

        spans = self.spans
        phase = pipeline.phase

        @contextlib.contextmanager
        def recorded(name):
            t0 = time.perf_counter()
            with phase(name):
                yield
            spans.append((name, t0, time.perf_counter()))

        self._patch(pipeline, "phase", recorded)
        self._patch(fasta, "phase", recorded)
        launch = _build.launch
        launches = self.launches

        def recorded_launch(name, dev, *args):
            if name in ("spsp_scan", "spsp_scan2"):
                launches.append((name, int(args[1]), int(args[2])))
            return launch(name, dev, *args)

        self._patch(_build, "launch", recorded_launch)

    def span(self, name, t0, t1) -> None:
        self.spans.append((name, t0, t1))

    # ---- the profiler around the window ----
    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.device.type != "cuda":
            acts = [torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._mark = time.perf_counter_ns()
            torch.full((1,), 7, device=self.device)
            torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        for module, attr, old in reversed(self._undo):
            setattr(module, attr, old)
        self._undo = []
        self.on = False
        if self.device.type != "cuda":
            return
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            a = e.start_ns()
            raw.append((a, a + e.duration_ns(), e.name()))
        raw.sort()
        if not raw:
            return
        # the marker is the first device operation; place it at the host
        # time it was launched
        off = raw[0][0] - self._mark
        self.events = [((a - off) / 1e9, (b - off) / 1e9, n)
                       for a, b, n in raw[1:]]

    # ---- readings ----
    def busy(self, t0: float, t1: float):
        """(busy seconds, merged busy intervals) inside [t0, t1]."""
        merged = []
        for a, b, _n in self.events:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return sum(b - a for a, b in merged), merged

    def device_ops(self, top: int = 10):
        tot = {}
        for a, b, n in self.events:
            tot[n] = tot.get(n, 0.0) + (b - a)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, t0: float, t1: float, top: int = 10):
        """The longest gaps between device operations in the window,
        each named by the host spans open at its middle."""
        _busy, merged = self.busy(t0, t1)
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)), reverse=True)
        out = []
        for length, a in gaps[:top]:
            mid = a + length / 2
            names = sorted({n for n, s0, s1 in self.spans if s0 <= mid <= s1})
            out.append(["+".join(names) or "outside_every_span", length])
        return out
