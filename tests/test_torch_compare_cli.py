"""The port's comparator, sort_csv and kmer_dump CLIs on the CPU
(TORCH_DEVICE=cpu): output files byte-identical to the goldens and to
the JAX package's CLIs, under both scoring engines."""

import gzip
import io
import json
import os
from contextlib import redirect_stdout

import pytest
import torch

from supersampler_tpu.cli import comparator as j_comparator
from supersampler_tpu.cli import kmer_dump as j_kmer_dump
from supersampler_tpu.cli import sort_csv as j_sort_csv
from supersampler_tpu_torch.cli import comparator as t_comparator
from supersampler_tpu_torch.cli import kmer_dump as t_kmer_dump
from supersampler_tpu_torch.cli import sort_csv as t_sort_csv

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
_ENGINES = ["numpy", "device"]


@pytest.fixture
def cfg(tmp_path, monkeypatch):
    """The family sketches symlinked under their golden names into a
    fresh CWD (the CSV header holds the names as the fof gives them),
    with all-vs-all, query and bank fofs; the port on the CPU."""
    with open(os.path.join(_GOLD, "meta.json")) as f:
        c = json.load(f)["compare"]
    for f_ in c["files"]:
        os.symlink(os.path.join(_GOLD, f_), tmp_path / f_)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    for name, files in (("fof.txt", c["files"]),
                        ("qfof.txt", c["query_files"]),
                        ("bfof.txt", c["bank_files"])):
        with open(name, "w") as f:
            f.write("\n".join(files) + "\n")
    return c


def _main(cli, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0
    return buf.getvalue()


def _untimed(out):
    return [x for x in out.splitlines() if "lasted" not in x]


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("query", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_comparator_cli_goldens(cfg, monkeypatch, engine, query, chunked):
    """Byte-equal to tests/golden/allvsall_* and query_*, and the same
    stdout as the JAX CLI (its timing lines aside)."""
    argv = (["-f", "bfof.txt", "-q", "qfof.txt",
             "-p", str(cfg["query_precision"]),
             "-m", str(cfg["query_min_threshold"])] if query
            else ["-f", "fof.txt"])
    if chunked:
        argv += ["--chunk-bytes", "16384"]
    monkeypatch.setenv("SPSP_COMPARE_ENGINE", engine)
    out = _main(t_comparator, argv + ["-o", "t"])
    gold = "query" if query else "allvsall"
    for kind in ("containment", "jaccard"):
        with open(os.path.join(_GOLD, f"{gold}_{kind}.csv.gz"), "rb") as f:
            ref = f.read()
        with open(f"t_{kind}.csv.gz", "rb") as f:
            assert f.read() == ref, f"{kind} csv.gz bytes differ"
    monkeypatch.setenv("SPSP_COMPARE_ENGINE", "numpy")
    assert _untimed(out) == _untimed(_main(j_comparator, argv + ["-o", "j"]))
    if not query:
        assert "I found 4 documents" in out


def test_comparator_cli_usage():
    assert _main(t_comparator, []) == t_comparator.USAGE == j_comparator.USAGE


@pytest.mark.parametrize("engine", _ENGINES)
def test_comparator_skips_unopenable(cfg, monkeypatch, engine):
    """An unopenable sketch drops out with the reference's message; the
    others still compare (reference Comparator.cpp:45-51), and the CSVs
    equal the JAX CLI's."""
    monkeypatch.setenv("SPSP_COMPARE_ENGINE", engine)
    files = cfg["files"]
    with open("fof_bad.txt", "w") as f:
        f.write(files[0] + "\nno_such_sketch.gz\n"
                + "\n".join(files[1:]) + "\n")
    assert "Problem with file opening" in _main(
        t_comparator, ["-f", "fof_bad.txt", "-o", "bad"])
    _main(t_comparator, ["-f", "fof.txt", "-o", "ok"])
    monkeypatch.setenv("SPSP_COMPARE_ENGINE", "numpy")
    _main(j_comparator, ["-f", "fof_bad.txt", "-o", "jbad"])
    for kind in ("containment", "jaccard"):
        ok = gzip.open(f"ok_{kind}.csv.gz", "rt").read().splitlines()
        bad = gzip.open(f"bad_{kind}.csv.gz", "rt").read().splitlines()
        # same scores; the header reproduces the reference's
        # names/indices misalignment (files_names[0:nb_files])
        assert bad[1:] == ok[1:]
        assert bad[0].split(",")[1] == "no_such_sketch.gz"
        with open(f"bad_{kind}.csv.gz", "rb") as f, \
                open(f"jbad_{kind}.csv.gz", "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("chunked", [False, True])
def test_comparator_engines_agree(cfg, monkeypatch, chunked):
    """Both engines write the same bytes through the CLI, the compacted
    indices of an unopenable file included."""
    with open("fof_bad.txt", "w") as f:
        f.write("no_such_sketch.gz\n" + "\n".join(cfg["files"]) + "\n")
    extra = ["--chunk-bytes", "1024"] if chunked else []
    for engine in _ENGINES:
        monkeypatch.setenv("SPSP_COMPARE_ENGINE", engine)
        _main(t_comparator, ["-f", "fof_bad.txt", "-o", engine] + extra)
        _main(t_comparator, ["-f", "bfof.txt", "-q", "fof_bad.txt", "-p",
                             "4", "-o", "q" + engine] + extra)
    for pre in ("", "q"):
        for kind in ("containment", "jaccard"):
            with open(f"{pre}numpy_{kind}.csv.gz", "rb") as f, \
                    open(f"{pre}device_{kind}.csv.gz", "rb") as g:
                assert f.read() == g.read()


def test_comparator_cli_raises_without_cuda(cfg, monkeypatch):
    """With no engine forced, the comparator runs the device engine on
    $TORCH_DEVICE; CUDA asked for and absent raises, with no drop to
    the numpy engine or the CPU."""
    monkeypatch.delenv("SPSP_COMPARE_ENGINE", raising=False)
    monkeypatch.setenv("TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_comparator.pick_engine() == "device"
    with pytest.raises(RuntimeError, match="TORCH_DEVICE"):
        _main(t_comparator, ["-f", "fof.txt"])
    assert not os.path.exists("results_containment.csv.gz")


@pytest.mark.parametrize("source", ["small", "jaccard"])
def test_sort_csv_roundtrip(cfg, source):
    """sort_csv reorders a matrix to a fof's order: a small symmetric
    matrix (mirrors tests/test_cli.py), and the comparator's own jaccard
    output against a reversed fof; output and stdout equal the JAX
    CLI's."""
    if source == "small":
        names = ["c.gz", "a.gz", "b.gz"]
        mat = [[1, 0.5, 0.25], [0.5, 1, 0.125], [0.25, 0.125, 1]]
        with open("in.csv", "w") as f:
            f.write(",".join(names) + "\n")
            for row in mat:
                f.write(",".join(str(v) for v in row) + "\n")
        src = "in.csv"
        order = ["a.gz", "b.gz", "c.gz"]
    else:
        src = os.path.join(_GOLD, "allvsall_jaccard.csv.gz")
        order = list(reversed(cfg["files"]))
    with open("order.txt", "w") as f:
        f.write("\n".join(order) + "\n")
    out = _main(t_sort_csv, [src, "t.csv", "order.txt"])
    assert out == _main(j_sort_csv, [src, "j.csv", "order.txt"])
    assert "The end" in out
    lines = open("t.csv").read().strip().split("\n")
    assert lines == open("j.csv").read().strip().split("\n")
    assert lines[0] == ",".join(order)
    if source == "small":
        assert lines[1:] == ["1,0.125,0.5", "0.125,1,0.25", "0.5,0.25,1"]


@pytest.mark.parametrize("name", ["gfam_fam0.gz",
                                  "sketch_big_k63_m15_s10_a1.gz",
                                  "sketch_edge_k21_m7_s5_a1.gz"])
def test_kmer_dump_matches_jax(tmp_path, name):
    """One k-mer a distinct pair, the same lines as the JAX kmer_dump,
    to a file and to stdout alike."""
    path = os.path.join(_GOLD, name)
    got, want = io.StringIO(), io.StringIO()
    n = t_kmer_dump.dump(path, got)
    assert n == j_kmer_dump.dump(path, want) and n > 0
    assert got.getvalue() == want.getvalue()
    out = str(tmp_path / "k.txt")
    assert t_kmer_dump.main([path, out]) == 0
    assert open(out).read() == got.getvalue()
    assert _main(t_kmer_dump, [path]) == got.getvalue()
    assert len(got.getvalue().splitlines()) == n
