"""Arithmetic that several metric readers share."""

from __future__ import annotations

from benchmark import roofline


def bases(run) -> float:
    return float(sum(w for _a, _b, w in run.calls))


def window_s(run) -> float:
    return run.t1 - run.t0


def phase_ms_per_mbase(run, *names):
    """Milliseconds of the program's phases (summed over its threads)
    per million bases sketched in the window; None where none ran."""
    if not any(n in run.phases for n in names):
        return None
    ms = 1e3 * sum(run.phases.get(n, 0.0) for n in names)
    return ms / (bases(run) / 1e6)


def idle_pct(run):
    """The device's idle share of the traced window, %; None without a
    trace that saw the device."""
    if run.trace is None or not run.trace.events:
        return None
    busy, _ = run.trace.busy(run.t0, run.t1)
    return 100.0 * (1.0 - busy / window_s(run))


def span_s_per_call(run, name):
    """Seconds of the entry's spans called name, per call."""
    if run.trace is None:
        return None
    spans = [b - a for n, a, b in run.trace.spans if n == name]
    if not spans:
        return None
    return sum(spans) / len(run.calls)


def kernel_roofline_pct(run, entry_name: str, kernel_name: str, v2: bool):
    """Summed least times of the kernel's launches over their summed
    device time, %, against the published peaks. Launches pair with the
    trace's kernels of that name in launch order (one device thread
    issues them all on one stream)."""
    tr = run.trace
    if tr is None:
        return None
    launches = [x for x in tr.launches if x[0] == entry_name]
    kern = [(a, b) for a, b, n in tr.events if kernel_name in n]
    if not launches or len(launches) != len(kern):
        return None
    pk = roofline.peaks(run.kind)
    least = sum(roofline.least_seconds(*roofline.scan_cost(P, P_rec, v2), pk)
                for _e, P, P_rec in launches)
    took = sum(b - a for a, b in kern)
    return 100.0 * least / took
