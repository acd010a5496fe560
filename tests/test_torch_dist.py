"""The port's multi-process orchestration (parallel/dist.py) on the CPU.

Mirrors tests/test_dist.py: shard ownership, single-process semantics, a
real 2-process gloo run (tests/torch_dist_worker.py, file store, the
CPU) whose rank-0 CSVs must equal the JAX package's numpy engine byte
for byte, the simulated two-process gather, and sketch ownership whose
union equals the JAX package's sketches byte for byte."""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from supersampler_tpu.compare.merge import TpuComparator
from supersampler_tpu.sketch import TpuSubsampler
from supersampler_tpu.sketch import subsample_file as j_subsample_file
from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.compare.reader import decode_sketch_pairs
from supersampler_tpu_torch.parallel import dist
from supersampler_tpu_torch.sketch import TorchSubsampler

_HERE = os.path.dirname(os.path.abspath(__file__))
_GOLD = os.path.join(_HERE, "golden")


def _golden_files():
    with open(os.path.join(_GOLD, "meta.json")) as f:
        cfg = json.load(f)["compare"]
    return [os.path.join(_GOLD, f_) for f_ in cfg["files"]]


def _numpy_ref(files, query_size=None):
    ref = TpuComparator(engine="numpy")
    ref.files_names = list(files)
    ref.compare_sketches(query_size or len(files))
    return ref


def _fastas(d, n=5, seed=7):
    """n small FASTAs of one family (point substitutions of one base)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 6000, dtype=np.uint8)
    paths = []
    for i in range(n):
        seq = base.copy()
        hit = rng.random(seq.size) < 0.01 * i
        seq[hit] = (seq[hit] + 1) % 4
        paths.append(os.path.join(d, f"g{i}.fa"))
        with open(paths[-1], "wb") as f:
            f.write(b">g%d\n" % i
                    + np.frombuffer(b"ACGT", np.uint8)[seq].tobytes() + b"\n")
    return paths


def _jax_sketches(fastas, s, d):
    """[(output name past its prefix, bytes)] of the JAX package's
    sketch of each FASTA, from one process."""
    out = []
    for path in fastas:
        ss = TpuSubsampler(k=31, m=11, s=s)
        sk = j_subsample_file(ss, path, os.path.join(d, "jax_"))
        with open(sk, "rb") as f:
            out.append((os.path.basename(sk)[4:], f.read()))
    return out


@pytest.fixture
def one_thread():
    """The plain sweep's many small ops run faster on one CPU thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_owned_shard_partitions():
    items = list(range(10))
    shards = [dist.owned_shard(items, i, 3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert shards[0] == [0, 3, 6, 9]


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    dist.initialize()          # must not raise nor set anything up
    assert not dist.dist.is_initialized()
    assert dist.process_info() == (0, 1)


def test_compare_distributed_single_process(monkeypatch):
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    files = _golden_files()
    comp = dist.compare_all_vs_all_distributed(files)
    ref = _numpy_ref(files)
    assert comp.score_A == ref.score_A and comp.score_A
    assert comp.nb_kmer_seen_infile == ref.nb_kmer_seen_infile
    assert comp.jaccard_csv() == ref.jaccard_csv()


@pytest.mark.parametrize("query_size", [None, 2])
def test_real_two_process_distributed_compare(tmp_path, query_size,
                                             one_thread):
    """Two gloo processes (file store, the CPU) run
    compare_all_vs_all_distributed, the real all-gather with unequal
    per-process pair counts, and sketch_fof_distributed; both ranks'
    CSVs equal the JAX numpy engine's, and the union of their sketches
    equals the JAX package's bytes."""
    files = _golden_files()
    fof = tmp_path / "fof.txt"
    fof.write_text("\n".join(files) + "\n")
    fastas = _fastas(str(tmp_path), n=3)
    sfof = tmp_path / "genomes.txt"
    sfof.write_text("\n".join(fastas) + "\n")
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    worker = os.path.join(_HERE, "torch_dist_worker.py")
    extra = ["--query-size", str(query_size)] if query_size else []
    procs = [subprocess.Popen(
        [sys.executable, worker, "--init",
         f"file://{tmp_path / 'store'}", "--rank", str(r), "--world", "2",
         "--out", str(out), "--fof", str(fof), "--sketch-fof", str(sfof),
         "--s", "10", *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            _out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()

    ref = _numpy_ref(files, query_size)
    for r in range(2):
        for kind, want in (("containment", ref.containment_csv()),
                           ("jaccard", ref.jaccard_csv())):
            with gzip.open(out / f"rank{r}_{kind}.csv.gz", "rt") as f:
                assert f.read() == want, (r, kind)
        rec = json.loads((out / f"rank{r}.json").read_text())
        assert rec["world"] == 2 and rec["forbidden_modules"] == []
    owned = [(out / f"rank{r}_sketches.txt").read_text().split()
             for r in range(2)]
    assert [len(o) for o in owned] == [2, 1]
    union = [owned[i % 2][i // 2] for i in range(len(fastas))]
    for got, (name, want) in zip(
            union, _jax_sketches(fastas, 10.0, str(tmp_path)), strict=True):
        assert os.path.basename(got) == "sk_" + name
        with open(got, "rb") as f:
            assert f.read() == want, name


def test_simulated_two_process_shard_gather_score():
    """The multi-process flow by hand: two processes decode disjoint
    strided file shards, the pair arrays concatenate (the all-gather),
    one comparator scores them (score_gathered_pairs, which puts them in
    file order): equal to one process's numpy engine."""
    files = _golden_files()
    parts = []
    k = m = 0
    for rank in range(2):
        for f, path in dist.owned_shard(list(enumerate(files)), rank, 2):
            mins, his, los, k, m, _ = decode_sketch_pairs(path)
            parts.append(np.stack([
                mins, his, los, np.full(mins.size, f, np.uint64)]))
    allp = np.concatenate(parts, axis=1)

    comp = TorchComparator(engine="device", device="cpu")
    comp.files_names = list(files)
    comp.k, comp.m = k, m
    dist.score_gathered_pairs(comp, allp, len(files))

    ref = _numpy_ref(files)
    assert comp.score_A == ref.score_A
    assert comp.nb_kmer_seen_infile == ref.nb_kmer_seen_infile
    assert comp.containment_csv() == ref.containment_csv()
    assert comp.jaccard_csv() == ref.jaccard_csv()


def test_sketch_fof_distributed_union_equals_jax(tmp_path, monkeypatch,
                                                one_thread):
    """The shards of two processes (process_info stood in for): disjoint,
    strided, and their union is byte-equal to one port process and to
    the JAX package sketching every entry."""
    fastas = _fastas(str(tmp_path), n=4, seed=3)

    def make():
        return TorchSubsampler(k=31, m=11, s=10.0, device="cpu")

    def sketch(rank, world, prefix):
        monkeypatch.setattr(dist, "process_info", lambda: (rank, world))
        return dist.sketch_fof_distributed(fastas, make,
                                           str(tmp_path / prefix))

    shards = [sketch(i, 2, "d_") for i in range(2)]
    one = sketch(0, 1, "o_")
    assert [len(s) for s in shards] == [2, 2]
    union = [shards[i % 2][i // 2] for i in range(4)]
    for got, mine, (name, want) in zip(
            union, one, _jax_sketches(fastas, 10.0, str(tmp_path)),
            strict=True):
        assert os.path.basename(got) == "d_" + name
        assert os.path.basename(mine) == "o_" + name
        with open(got, "rb") as f, open(mine, "rb") as g:
            assert f.read() == g.read() == want, name
