"""One rank of a multi-process run of the port's parallel/dist.py.

    python tests/torch_dist_worker.py --init file://<dir>/store \
        --rank R --world W --out DIR [--fof FOF [--query-size Q]] \
        [--sketch-fof FOF --s S]

Joins the gloo group (initialize), then with --fof runs
compare_all_vs_all_distributed over the sketches listed there and writes
DIR/rankR_{containment,jaccard}.csv.gz, and with --sketch-fof runs
sketch_fof_distributed at k=31, m=11 and -s S with outputs
DIR/sk_<stem>.gz, listing them in DIR/rankR_sketches.txt. Both run on
$TORCH_DEVICE (default cuda). DIR/rankR.json records the walls and the
kernel launches. The rank imports no jax and nothing of
supersampler_tpu, and fails if it did. Used by tests/test_torch_dist.py
on the CPU and by chip_smoke.py on the card."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from supersampler_tpu_torch import default_device  # noqa: E402
from supersampler_tpu_torch.ops.field import sweep_kernel  # noqa: E402
from supersampler_tpu_torch.ops.fused import scan2_kernel  # noqa: E402
from supersampler_tpu_torch.ops.scan_kernel import scan_kernel  # noqa: E402
from supersampler_tpu_torch.parallel import dist as D  # noqa: E402
from supersampler_tpu_torch.parallel.compare_dist import (  # noqa: E402
    presence_product)
from supersampler_tpu_torch.sketch import TorchSubsampler  # noqa: E402


def _lines(path):
    with open(path) as f:
        return [ln.strip() for ln in f if len(ln.strip()) > 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fof")
    ap.add_argument("--query-size", type=int)
    ap.add_argument("--sketch-fof")
    ap.add_argument("--s", type=float, default=100.0)
    a = ap.parse_args(argv)

    t0 = time.perf_counter()
    D.initialize(a.init, a.world, a.rank)
    rank, world = D.process_info()
    if (rank, world) != (a.rank, a.world):
        raise RuntimeError(f"process group is {(rank, world)}")
    walls = {"init": time.perf_counter() - t0}
    stem = os.path.join(a.out, f"rank{rank}")
    if a.fof:
        t = time.perf_counter()
        comp = D.compare_all_vs_all_distributed(_lines(a.fof),
                                                query_size=a.query_size)
        walls["compare"] = time.perf_counter() - t
        comp.write_outputs(stem)
    if a.sketch_fof:
        device = default_device()
        t = time.perf_counter()
        outs = D.sketch_fof_distributed(
            _lines(a.sketch_fof),
            lambda: TorchSubsampler(k=31, m=11, s=a.s, device=device),
            os.path.join(a.out, "sk_"))
        walls["sketch"] = time.perf_counter() - t
        with open(stem + "_sketches.txt", "w") as f:
            f.writelines(p + "\n" for p in outs)
    dist.barrier()
    dist.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "supersampler_tpu"))
    with open(stem + ".json", "w") as f:
        json.dump({"rank": rank, "world": world, "walls": walls,
                   "forbidden_modules": bad,
                   "launches": {"scan": scan_kernel.launches,
                                "scan2": scan2_kernel.launches,
                                "sweep": sweep_kernel.launches,
                                "int_mm": presence_product.launches}}, f)
    if bad:
        print(f"rank {rank} imported {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
