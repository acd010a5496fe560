"""The control of each cell's check: the plain reference put in the
program's place with one of the configuration's guarantees broken,
judged by the cell's own check against the plain reference. The check
has to find it wrong.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3
        [--break forward_strand|float32|float64]

forward_strand (the control): minimizers hashed on the forward strand
only, where the tool hashes the canonical m-mer of both strands; the
step that would halve the hashing. float32 and float64: the FHS
threshold (80-bit long double in the tool) in a lower precision, which
moves it by 0.037 % and by 6.5e-13: too little for a run to see on most
seeds, so they are readings, not the control.

One JSON line a seed: the numbers, their limits, and which the control
fails. Runs on the card when there is one; it does not run the
program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from benchmark.run import ROOT, Ctx, _load, cell

BREAKS = ("forward_strand", "float32", "float64")


def control_numbers(root, workload, seed, device, broken="forward_strand"):
    """({number: value}, {number: limit}) of the control at one seed."""
    from benchmark import gen
    from benchmark.reference.sketch import threshold

    _w, cfg, traffic, _e2e, _pl = cell(root, workload)
    ctx = Ctx(cfg, traffic, seed, device, None)
    entry = _load(root, "entries", traffic["entry"]).Entry(ctx)
    with tempfile.TemporaryDirectory(prefix="spspcontrol-") as tmp:
        ctx.inputs = gen.make(cfg, traffic, seed, device, tmp, root)
    entry.paths = [i.path[: -len(".fa")] + ".sketch.gz" for i in ctx.inputs]
    t = cfg["tool"]
    if broken == "forward_strand":
        kw = {"canonical": False}
    else:
        kw = {"thr": threshold(t["k"], t["m"], t["s"],
                               getattr(np, broken))}
    return entry.control(**kw), traffic["limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--break", dest="broken", choices=BREAKS,
                    default=BREAKS[0])
    a = ap.parse_args(argv)
    import torch

    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in a.seeds:
        t0 = time.perf_counter()
        nums, limits = control_numbers(ROOT, a.workload, seed, dev,
                                       a.broken)
        print(json.dumps({
            "workload": a.workload, "seed": seed, "broken": a.broken,
            "device": str(dev), "numbers": nums, "limits": limits,
            "control_fails": [k for k in limits if nums[k] > limits[k]],
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.pop("SPSP_TRACE", None)
    sys.exit(main())
