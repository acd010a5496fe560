"""The program's own spans and counters in a traced run.

The program records them (``timers`` of supersampler_tpu_torch's
utils/profiling.py) while a torch.profiler session is active, which the
traced window is: a span is (name, t0, t1, thread, span id, parent span
id, call id) on time.perf_counter, the clock the trace places the
device's operations on; a counter is (name, n, t, thread, call id). A
span's self time is its duration less the union of its direct
children on the same thread. A program that records neither gives None,
and each reader of these then leaves its metric out.
"""

from __future__ import annotations

from collections import defaultdict


def program(run):
    """(spans, counters) the program recorded inside [run.t0, run.t1];
    None without a trace, without such records, or where the program's
    buffer dropped some (the sums would come out short)."""
    if run.trace is None:
        return None
    from supersampler_tpu_torch.utils.profiling import timers

    if not hasattr(timers, "spans") or getattr(timers, "dropped", 0):
        return None
    spans = [s for s in timers.spans() if run.t0 <= s[1] and s[2] <= run.t1]
    counters = [c for c in timers.counters() if run.t0 <= c[2] <= run.t1]
    return (spans, counters) if spans else None


def union(intervals, lo=float("-inf"), hi=float("inf")) -> list:
    """The union of the intervals inside [lo, hi], as disjoint sorted
    (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def covered(intervals, lo=float("-inf"), hi=float("inf")) -> float:
    """Seconds of [lo, hi] covered by the union of the intervals."""
    return sum(b - a for a, b in union(intervals, lo, hi))


def self_seconds(spans) -> dict:
    """{name: summed self time, s} over the spans."""
    kids = defaultdict(list)
    for s in spans:
        if s[5] is not None:
            kids[(s[5], s[3])].append((s[1], s[2]))
    out = defaultdict(float)
    for s in spans:
        out[s[0]] += (s[2] - s[1]) - covered(kids.get((s[4], s[3]), ()),
                                             s[1], s[2])
    return dict(out)


def self_s_per_call(run, name):
    """Self time of the program's spans called name per call of the
    window, s; None where there are none."""
    got = program(run)
    if got is None:
        return None
    per = self_seconds(got[0])
    return per[name] / len(run.calls) if name in per else None


def counter_total(run, name):
    """The program's counter name summed over the window; None where it
    was never counted."""
    got = program(run)
    if got is None:
        return None
    ns = [c[1] for c in got[1] if c[0] == name]
    return sum(ns) if ns else None


def idle_outside_spans_pct(run):
    """The share of the window in which the device is idle inside a
    span of the program that has spans below it (a comparison's root,
    ``compare.call``) but no span below it is open, on any thread, %:
    the time of the program's own body that no layer's span names.
    Spans with a parent, and roots without children (each CSV), are
    the layers. The harness's time between calls is not counted. None
    without device operations in the trace or without the program's
    spans."""
    if run.trace is None or not run.trace.events:
        return None
    got = program(run)
    if got is None:
        return None
    parents = {s[5] for s in got[0] if s[5] is not None}
    bodies, named = [], []
    for s in got[0]:
        if s[5] is None and s[4] in parents:
            bodies.append((s[1], s[2]))
        else:
            named.append((s[1], s[2]))
    _busy, merged = run.trace.busy(run.t0, run.t1)
    named += [(a, b) for a, b in merged]
    unnamed = 0.0
    for a, b in union(bodies, run.t0, run.t1):
        unnamed += (b - a) - covered(named, a, b)
    return 100.0 * unnamed / (run.t1 - run.t0)
