"""The harness on the CPU at tiny sizes: every cell runs and is correct;
a configuration, a traffic mix and a metric added as new files are
taken up; the timed path broken underneath makes ``correct`` false; the
control fails its check; nothing loads JAX or the JAX package."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import control, run
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def _run(root, workload, trace=0, seconds=0.2):
    return run.run_cell(root, workload, SEED, seconds, trace, CPU)


@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_correct(root, trace):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in tiny.workloads(root):
        r = _run(root, w, trace)
        assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
        assert list(r)[-1] == "checks"
        want = [m["name"] for m in bench["per_layer" if trace
                                         else "end_to_end"]
                if w in m.get("workloads", [w])]
        got = set(r["metrics"])
        if trace:
            # on the CPU the trace sees no device: those readers are silent
            want = [n for n in want if "idle_pct" not in n
                    and "roofline" not in n]
        assert set(want) <= got, (w, want, got)


def test_new_files_are_taken_up(root, tmp_path):
    """A configuration, a traffic mix and a metric reader, each a new
    file, plus their entries in BENCHMARK.json: no existing file of the
    benchmark is edited."""
    new = tiny.make(str(tmp_path / "grown"))
    b = os.path.join(new, "benchmark")
    before = _tree(b)
    with open(os.path.join(b, "configs", "bact_genomes.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "small_genomes"
    cfg["inputs"].update(length_min=10000, length_max=12000)
    with open(os.path.join(b, "configs", "small_genomes.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "pairs.json"), "w") as f:
        json.dump({"entry": "sketch", "call": "sketch_fof", "genomes": 2,
                   "files_per_call": 2, "limits": {
                       "sketches_missing": 0, "pairs_missing": 0,
                       "pairs_extra": 0, "kept_count_gap": 0}}, f)
    with open(os.path.join(b, "metrics", "calls.count.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.calls))\n")
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "small_genomes", "source": "x",
                             "file": "benchmark/configs/small_genomes.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "small_genomes.pairs",
                               "config": "small_genomes", "traffic": "pairs",
                               "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "sketch_mbases_s")["workloads"].append(
        "small_genomes.pairs")
    bench["end_to_end"].append({"name": "calls.count", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["small_genomes.pairs"]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = run.run_cell(new, "small_genomes.pairs", SEED, 0.2, 0, CPU)
    assert r["correct"]
    assert set(r["metrics"]) == {"sketch_mbases_s", "calls.count",
                                 "setup_s"}
    assert r["metrics"]["calls.count"]["value"] == r["attempted"]
    after = _tree(b)
    assert all(after[p] == data for p, data in before.items())


def _tree(top):
    """{relative path: bytes} of the files under top."""
    out = {}
    for dp, _d, fs in os.walk(top):
        for f in fs:
            if "__pycache__" not in dp:
                p = os.path.join(dp, f)
                out[os.path.relpath(p, top)] = open(p, "rb").read()
    return out


def _sketch_faults(pipeline):
    """{fault: (attribute of pipeline or of TorchSubsampler, stand-in)}."""
    serialize = pipeline.TorchSubsampler.serialize

    def unchanged(self):
        # the sketch of the state as it was before any record
        return serialize(pipeline.TorchSubsampler(
            self.k, self.m, self.s, self.abundance, device=self.device))

    def altered(self):
        raw = bytearray(serialize(self))
        body = raw.index(b"\n") + 1
        raw[body] = ord("A") if raw[body] != ord("A") else ord("C")
        return bytes(raw)

    spans = pipeline.stream_fasta_spans

    def half(path, *a, **kw):
        for data, sp in spans(path, *a, **kw):
            # half of each chunk's records, and half of a lone record
            sp = sp[: max(1, len(sp) // 2)]
            if len(sp) == 1:
                s, e = sp[0]
                sp = [(s, s + (e - s) // 2)]
            yield data, sp

    return {"state_unchanged": ("serialize", unchanged),
            "half_left_out": ("stream_fasta_spans", half),
            "answer_altered": ("serialize", altered)}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", ["bact_genomes.fof32",
                                      "short_reads.isolate30x",
                                      "bact_genomes.per_genome"])
def test_sketch_faults_fail(root, monkeypatch, workload, fault):
    from supersampler_tpu_torch.sketch import pipeline

    if workload not in tiny.workloads(root):
        pytest.skip(f"{workload} is not in BENCHMARK.json")
    name, fn = _sketch_faults(pipeline)[fault]
    if name == "serialize":
        monkeypatch.setattr(pipeline.TorchSubsampler, name, fn)
    else:
        monkeypatch.setattr(pipeline, name, fn)
    r = _run(root, workload)
    assert not r["correct"]
    assert r["failed"] == r["attempted"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_compare_faults_fail(root, monkeypatch, fault):
    import numpy as np
    from supersampler_tpu_torch.compare import merge

    if "bact_genomes.allvsall100" not in tiny.workloads(root):
        pytest.skip("no comparison cell")
    if fault == "state_unchanged":
        real = merge.score_matrix_device

        def zero(*a, **kw):
            return np.zeros_like(np.asarray(real(*a, **kw)))
        monkeypatch.setattr(merge, "score_matrix_device", zero)
    elif fault == "half_left_out":
        real = merge.decode_files

        def half(files, q=None):
            out = list(real(files, q))
            n = out[0].size // 2
            out[:4] = [a[:n] for a in out[:4]]
            return tuple(out)
        monkeypatch.setattr(merge, "decode_files", half)
    else:
        real = merge.TorchComparator.containment_csv

        def altered(self):
            lines = real(self).split("\n")
            cells = lines[2].split(",")
            cells[1] = "0.5" if cells[1] != "0.5" else "0.25"
            lines[2] = ",".join(cells)
            return "\n".join(lines)
        monkeypatch.setattr(merge.TorchComparator, "containment_csv", altered)
    r = _run(root, "bact_genomes.allvsall100")
    assert not r["correct"]


def test_control_fails(root):
    """The control (forward-strand minimizers in the program's place)
    fails the check of every cell."""
    for w in tiny.workloads(root):
        nums, limits = control.control_numbers(root, w, SEED, CPU)
        assert any(nums[k] > limits[k] for k in limits), (w, nums)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_anywhere_in_the_benchmark():
    """By whole top-level name: supersampler_tpu_torch begins with
    supersampler_tpu and is allowed; the reference imports nothing of
    the program."""
    bdir = os.path.join(tiny.REPO, "benchmark")
    for dp, _d, fs in os.walk(bdir):
        for f in fs:
            if not f.endswith(".py"):
                continue
            tops = {m.split(".")[0] for m in _imports(os.path.join(dp, f))}
            assert not tops & {"jax", "jaxlib", "flax", "supersampler_tpu"}
            if os.path.basename(dp) == "reference":
                assert "supersampler_tpu_torch" not in tops, f


def test_a_run_loads_no_jax(root):
    code = (
        "import sys, torch\n"
        "from benchmark import run\n"
        f"r = run.run_cell({root!r}, 'bact_genomes.per_genome', 1, 0.1, 1, "
        "torch.device('cpu'))\n"
        "assert r['correct']\n"
        "tops = {n.split('.')[0] for n in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'supersampler_tpu',"
        " 'supersampler_tpu_torch'}))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "['supersampler_tpu_torch']"


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "bact_genomes.allvsall100", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
