"""Run one cell of the benchmark of supersampler_tpu_torch.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Everything a cell is made of is found by name: its entry in
BENCHMARK.json names a configuration (benchmark/configs/<name>.json)
and a traffic mix (benchmark/traffic/<name>.json); the traffic names
the entry that drives the program (benchmark/entries/<entry>.py); an
input kind that gen.py does not build is benchmark/inputs/<kind>.py;
each metric is read by benchmark/metrics/<metric name>.py.

A run: the card and the program; inputs made from the seed on the card and written
under $TMPDIR; the entry's set-up and one warm-up call, all counted in
setup_s; then calls, back to back, until ``--seconds`` have passed
(whole calls only; the window ends with the last); with ``--trace 1``
the window runs under torch.profiler and the program's phases and
launches are recorded. After the window: the memory peak, the program's
state freed, every output checked against the plain reference, and a
check that neither JAX nor the JAX package got loaded. The last line of
standard output is the result; the last lines of standard error are
each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

T_START = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "supersampler_tpu"}
PROGRAM_ENV = ("SPSP_TRACE", "SPSP_FUSED", "TORCH_DEVICE",
               "SPSP_COMPARE_ENGINE")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: str, workload: str):
    """(workload entry, config, traffic, end-to-end and per-layer metric
    entries of this cell) from BENCHMARK.json and the benchmark's
    files."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = wl[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(root, cfg["file"]))
    traffic = _json(os.path.join(root, "benchmark", "traffic",
                                 w["traffic"] + ".json"))

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    return w, config, traffic, mine(bench["end_to_end"]), \
        mine(bench["per_layer"])


def _load(root: str, folder: str, name: str):
    """The module benchmark/<folder>/<name>.py of the tree at root."""
    path = os.path.join(root, "benchmark", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, name: str):
    """The metric's reader: ``read(run)`` of metrics/<name>.py."""
    return _load(root, "metrics", name).read


class Ctx:
    """What an entry sees: the cell's configuration and traffic, the
    seed, the device, the inputs, the trace (or None) and the log."""

    def __init__(self, cfg, traffic, seed, device, trace):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.trace = device, trace
        self.inputs = []
        self.log = log


class Run:
    """What a metric's reader sees of a run."""

    def __init__(self):
        self.setup_s = None
        self.setup_parts = {}
        self.calls = []           # (t0, t1, work) of each call
        self.t0 = self.t1 = None  # the window
        self.phases = {}          # the program's phase totals, s
        self.trace = None
        self.kind = None          # the card's name


def run_cell(root, workload, seed, seconds, trace, device, t_start=None):
    """One run of a cell on ``device`` (a torch.device). Returns the
    result dict; logs to standard error."""
    import torch

    from benchmark import gen, steady
    from benchmark.trace import Trace

    t_start = time.perf_counter() if t_start is None else t_start
    w, cfg, traffic, e2e, per_layer = cell(root, workload)
    import supersampler_tpu_torch  # noqa: F401  (the program)
    from supersampler_tpu_torch.utils.profiling import timers

    run = Run()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        run.kind = torch.cuda.get_device_name(device)
        log(f"card: {run.kind}, power limit "
            f"{steady._smi('power.limit') or 'not read'}")
    else:
        run.kind = str(device)
    t_card = time.perf_counter()
    tr = Trace(device) if trace else None
    ctx = Ctx(cfg, traffic, seed, device, tr)
    entry = _load(root, "entries", traffic["entry"]).Entry(ctx)
    tmp = tempfile.mkdtemp(prefix="spspbench-")
    try:
        ctx.inputs = gen.make(cfg, traffic, seed, device, tmp, root)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t_inputs = time.perf_counter()
        entry.setup()
        t_setup = time.perf_counter()
        for i in range(entry.warmup_calls()):
            entry.call(i)
        t_warm = time.perf_counter()
        log(steady.host_line("before the window"))
        if tr is not None:
            tr.instrument(entry)
        timers.reset()
        run.setup_s = time.perf_counter() - t_start
        run.setup_parts = {"imports and card": t_card - t_start,
                           "inputs": t_inputs - t_card,
                           "set-up sketches": t_setup - t_inputs,
                           "warm-up": t_warm - t_setup}
        log(f"set-up {run.setup_s:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in run.setup_parts.items())
            + f" ({sum(i.bases for i in ctx.inputs)} bases in "
            f"{len(ctx.inputs)} files)")

        # ---- the window ----
        if tr is not None:
            tr.start()
        outputs = []
        run.t0 = time.perf_counter()
        end = run.t0 + seconds
        while True:
            a = time.perf_counter()
            out, work = entry.call(len(outputs))
            b = time.perf_counter()
            run.calls.append((a, b, work))
            outputs.append(out)
            if b >= end:
                break
        run.t1 = b
        run.phases = dict(timers.totals)
        if tr is not None:
            tr.stop()
            for i, (a, b, _w) in enumerate(run.calls):
                tr.span("call", a, b)
            run.trace = tr
        log(steady.host_line("after the window"))
        walls = sorted(b - a for a, b, _ in run.calls)
        half = len(run.calls) // 2
        log("call walls ms: " + " ".join(
            f"{1e3 * (b - a):.1f}" for a, b, _w in run.calls))
        log(f"window {run.t1 - run.t0:.3f} s: {len(run.calls)} calls, wall "
            f"median {1e3 * walls[len(walls) // 2]:.3f} ms, min "
            f"{1e3 * walls[0]:.3f}, max {1e3 * walls[-1]:.3f}; medians of "
            f"the first and second half "
            f"{1e3 * _median([b - a for a, b, _ in run.calls[:half]]):.3f}, "
            f"{1e3 * _median([b - a for a, b, _ in run.calls[half:]]):.3f} ms")

        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        entry.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        nums, failed = entry.check(outputs)
        del outputs
        log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    loaded = sorted({n.split(".")[0] for n in sys.modules} & FORBIDDEN)
    if loaded:
        raise SystemExit(f"the run loaded {loaded}: the port must not")

    metrics = {}
    for m in (per_layer if trace else e2e):
        v = reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = traffic["limits"]
    correct = failed == 0 and all(nums[k] <= limits[k] for k in limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.kind, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        busy, _ = run.trace.busy(run.t0, run.t1)
        dev["busy_s"] = busy
        dev["window_s"] = run.t1 - run.t0
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops()],
            "idle_gaps": run.trace.idle_gaps(run.t0, run.t1)}
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                        for k in limits}
    for k in limits:
        log(f"check {k}: {nums[k]} (limit {limits[k]})")
    return result


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for var in PROGRAM_ENV:
        os.environ.pop(var, None)

    from benchmark import steady
    log(steady.cpu_line())
    import torch

    w = cell(ROOT, a.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        log(f"{a.workload} needs {w['chips']} CUDA card(s); this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = run_cell(ROOT, a.workload, a.seed, a.seconds, a.trace,
                          torch.device("cuda", 0), T_START)
    except ImportError as e:
        log(f"the program is not in this checkout: {e}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
