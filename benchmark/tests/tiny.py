"""A copy of the benchmark at sizes a CPU test can hold. Each
configuration and traffic file that a cell uses carries its own cut
under the key "cpu_test" (a dict value updates that key one level deep,
a scalar replaces it; {} means already small), so a cell added as new
files is cut with no edit here. The copy's BENCHMARK.json also holds the
cells that PERF.md keeps for later (tests/later_cells.json), so their
traffic, entry and readers stay tested."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(path, d):
    with open(path, "w") as f:
        json.dump(d, f)


def _cut(path):
    """Apply the file's own "cpu_test" block to it, in place."""
    d = _load(path)
    if "cpu_test" not in d:
        raise ValueError(f"{path} has no \"cpu_test\" block: a cell uses "
                         "it, and the CPU copy would run it at full size")
    for key, val in d["cpu_test"].items():
        if isinstance(val, dict):
            d[key].update(val)
        else:
            d[key] = val
    _dump(path, d)


def make(dst: str, src: str = REPO) -> str:
    """The benchmark tree of src (BENCHMARK.json and benchmark/) at dst,
    every file that a cell uses cut by its own "cpu_test". Returns dst."""
    shutil.copytree(os.path.join(src, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _load(os.path.join(src, "BENCHMARK.json"))
    for key, rows in _load(os.path.join(src, "benchmark", "tests",
                                        "later_cells.json")).items():
        bench[key] += rows
    _dump(os.path.join(dst, "BENCHMARK.json"), bench)
    files = {c["name"]: c["file"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        used.add(files[w["config"]])
        used.add(os.path.join("benchmark", "traffic", w["traffic"] + ".json"))
    for rel in sorted(used):
        _cut(os.path.join(dst, rel))
    return dst


def workloads(root: str) -> list:
    return [w["name"] for w in _load(os.path.join(root, "BENCHMARK.json"))
            ["workloads"]]
