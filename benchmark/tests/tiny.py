"""A copy of the benchmark at sizes a CPU test can hold: genomes of
20-30 kb, 400 reads, a few files, s = 20 (at s = 1000 such genomes keep
almost nothing). The copy's BENCHMARK.json also holds the cells that
PERF.md keeps for later (later_cells.json: fof32, isolate30x,
per_genome, their metrics), so their traffic, entry and readers stay
tested."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _edit(path, **upd):
    with open(path) as f:
        d = json.load(f)
    for key, val in upd.items():
        if isinstance(val, dict):
            d[key].update(val)
        else:
            d[key] = val
    with open(path, "w") as f:
        json.dump(d, f)


def make(dst: str) -> str:
    """The benchmark tree at dst (BENCHMARK.json and benchmark/), cut to
    tiny sizes. Returns dst."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "later_cells.json")) as f:
        later = json.load(f)
    for key, rows in later.items():
        bench[key] += rows
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cfgs = os.path.join(dst, "benchmark", "configs")
    _edit(os.path.join(cfgs, "bact_genomes.json"), tool={"s": 20.0},
          inputs={"length_min": 20000, "length_max": 30000})
    _edit(os.path.join(cfgs, "short_reads.json"), tool={"s": 20.0},
          inputs={"genome_length": 20000, "reads": 400})
    tr = os.path.join(dst, "benchmark", "traffic")
    _edit(os.path.join(tr, "fof32.json"), genomes=3, files_per_call=3)
    _edit(os.path.join(tr, "per_genome.json"), genomes=2)
    _edit(os.path.join(tr, "allvsall100.json"), species=2, strains=3)
    return dst


def workloads(root: str) -> list:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
