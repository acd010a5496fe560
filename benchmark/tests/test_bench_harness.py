"""The harness on the CPU at tiny sizes: every cell runs and is correct;
a configuration, an input kind, a traffic mix and a metric added as new
files are cut and taken up; the timed path broken underneath makes
``correct`` false; the control fails its check; nothing loads JAX or
the JAX package."""

import ast
import json
import os
import re
import shutil
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


# A cell added as new files alone: a configuration of genomes that each
# carry one plasmid shared by all, made by an input kind of its own,
# compared all against all by the existing compare entry; full sizes
# that the CPU could not hold, each file with its own cut.
_GROWN = {
    "configs/plasmid_genomes.json": {
        "name": "plasmid_genomes",
        "tool": {"k": 31, "m": 11, "s": 1000.0, "abundance": 1},
        "inputs": {"kind": "with_plasmid", "chromosome": 5000000,
                   "plasmid": 100000, "line_width": 80},
        "cpu_test": {"tool": {"s": 20.0},
                     "inputs": {"chromosome": 20000, "plasmid": 3000}}},
    "traffic/plasmids.json": {
        "entry": "compare", "genomes": 24,
        "comparator": {"precision": 6, "min_threshold": 0.0},
        "limits": {"csv_cells_wrong": 0}, "cpu_test": {"genomes": 3}},
    "inputs/with_plasmid.py": (
        "import os\n"
        "import numpy as np\n"
        "import torch\n"
        "from benchmark import gen\n\n\n"
        "def make(cfg, traffic, seed, device, out_dir):\n"
        "    g = gen.generator(seed, device)\n"
        "    inp = cfg['inputs']\n"
        "    plasmid = gen.random_bases(inp['plasmid'], g, device)\n"
        "    out = []\n"
        "    for b in range(traffic['genomes']):\n"
        "        chrom = gen.random_bases(inp['chromosome'], g, device)\n"
        "        path = os.path.join(out_dir, f'g{b:03d}.fa')\n"
        "        w = inp['line_width']\n"
        "        gen.write(path, gen.fasta_record('chr', chrom, w)\n"
        "                  + gen.fasta_record('pl', plasmid, w))\n"
        "        seq = torch.cat([chrom, plasmid]).cpu().numpy()\n"
        "        out.append(gen.Input(path, seq, np.array(\n"
        "            [0, chrom.numel(), seq.size], np.int64)))\n"
        "    return out\n"),
    "metrics/calls.per_window.py": (
        "def read(run):\n    return float(len(run.calls))\n"),
}
_CELL = "plasmid_genomes.plasmids"


def _grow(dst):
    """A copy of the repo's benchmark tree at dst, grown by _GROWN's
    files and their entries in BENCHMARK.json. Returns
    {relative path: bytes} of the copy's benchmark/ before it grew."""
    shutil.copytree(os.path.join(tiny.REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), dst)
    before = _tree(os.path.join(dst, "benchmark"))
    for rel, body in _GROWN.items():
        path = os.path.join(dst, "benchmark", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(body if isinstance(body, str) else json.dumps(body))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "plasmid_genomes", "source": "x",
        "file": "benchmark/configs/plasmid_genomes.json", "reduced": [],
        "why": "x"})
    bench["workloads"].append({"name": _CELL, "config": "plasmid_genomes",
                               "traffic": "plasmids", "chips": 1,
                               "why": "x"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "compare_s")["workloads"].append(_CELL)
    bench["per_layer"].append({
        "name": "calls.per_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "harness", "moves": "compare_s",
        "workloads": [_CELL]})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return before


def test_a_configuration_is_added_as_new_files(tmp_path):
    """A configuration, an input kind, a traffic mix and a reader, each
    a new file, plus their entries in BENCHMARK.json: tiny.make cuts the
    new cell by the files' own blocks, it runs correct on the CPU, and
    no existing file of the benchmark is edited."""
    grown = str(tmp_path / "grown")
    before = _grow(grown)
    cut = tiny.make(str(tmp_path / "cut"), grown)
    with open(os.path.join(cut, "benchmark", "configs",
                           "plasmid_genomes.json")) as f:
        assert json.load(f)["inputs"]["chromosome"] == 20000
    for trace, want in ((0, {"compare_s", "setup_s"}),
                        (1, {"calls.per_window"})):
        r = run.run_cell(cut, _CELL, SEED, 0.2, trace, CPU)
        assert r["correct"] and r["failed"] == 0
        assert set(r["metrics"]) == want
    assert r["metrics"]["calls.per_window"]["value"] == r["attempted"]
    assert r["checks"]["csv_cells_wrong"]["value"] == 0
    after = _tree(os.path.join(grown, "benchmark"))
    assert all(after[p] == data for p, data in before.items())


@pytest.mark.parametrize("rel", ["configs/bact_genomes.json",
                                 "traffic/allvsall100.json"])
def test_a_used_file_without_its_cut_is_refused(tmp_path, rel):
    grown = str(tmp_path / "grown")
    _grow(grown)
    path = os.path.join(grown, "benchmark", rel)
    with open(path) as f:
        d = json.load(f)
    del d["cpu_test"]
    with open(path, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match=os.path.basename(rel)):
        tiny.make(str(tmp_path / "cut"), grown)


def test_the_cut_blocks_change_no_input(root, tmp_path):
    """For one seed, every cell's inputs are the same bytes with the
    "cpu_test" blocks there and taken out."""
    from benchmark import gen

    for w in tiny.workloads(root):
        _w, cfg, traffic, _e, _p = run.cell(root, w)
        made = []
        for strip in (False, True):
            if strip:
                cfg, traffic = ({k: v for k, v in d.items()
                                 if k != "cpu_test"} for d in (cfg, traffic))
            out = tmp_path / f"{w}.{strip}"
            out.mkdir()
            inputs = gen.make(cfg, traffic, SEED, CPU, str(out), root)
            made.append([(os.path.basename(i.path),
                          open(i.path, "rb").read(), i.starts.tolist())
                         for i in inputs])
        assert made[0] == made[1], w


def test_an_unknown_input_kind_names_its_file(root, tmp_path):
    from benchmark import gen

    cfg = {"inputs": {"kind": "nosuch"}}
    want = os.path.join(root, "benchmark", "inputs", "nosuch.py")
    with pytest.raises(ValueError, match=re.escape(want)):
        gen.make(cfg, {}, SEED, CPU, str(tmp_path), root)


def test_nothing_that_runs_on_the_chip_reads_the_cuts():
    bdir = os.path.join(tiny.REPO, "benchmark")
    for dp, ds, fs in os.walk(bdir):
        ds[:] = [d for d in ds if d != "tests"]
        for f in fs:
            if f.endswith(".py"):
                with open(os.path.join(dp, f)) as fh:
                    assert "cpu_test" not in fh.read(), f


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
