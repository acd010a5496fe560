"""The PyTorch port imports no JAX and nothing of supersampler_tpu.

A fresh interpreter imports every module of supersampler_tpu_torch,
sketches a small FASTA on the CPU (alone, through device dedup and the
Python k-mer store, and as a fof through sketch_fof, reading the phase
timers) and with the port's scalar oracle (the same bytes), runs the
sub_sampler CLI (-i and -f), the comparator CLI over the family goldens,
the norms CLI (eval/norms.py) over the comparator's CSVs and the
multi-device dry run (parallel/dryrun.py, with parallel/mesh.py and
parallel/dist.py) over two CPU entries; ``jax`` and
``supersampler_tpu`` / ``supersampler_tpu.*`` are then still absent
from sys.modules. The port's copies of the host layer are held to their
JAX-package originals."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

import supersampler_tpu.core.scalar as JS
import supersampler_tpu.io.fasta as JFA
import supersampler_tpu.io.gzip_exact as JGZ
import supersampler_tpu.oracle.subsampler as JOS
import supersampler_tpu_torch.core.scalar as TS
import supersampler_tpu_torch.io.fasta as TFA
import supersampler_tpu_torch.io.gzip_exact as TGZ

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import contextlib, importlib, io, os, pkgutil, random, sys, tempfile
import supersampler_tpu_torch as pkg
REPO = os.getcwd()
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 44, names
from supersampler_tpu_torch.cli import comparator, sub_sampler
from supersampler_tpu_torch.eval import norms
from supersampler_tpu_torch.oracle import OracleSubsampler
from supersampler_tpu_torch.sketch import TorchSubsampler
rng = random.Random(5)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "g.fa.gz")
    with open(path, "wb") as f:
        f.write(__import__("gzip").compress(b"".join(
            b">r%d\\n" % i + "".join(rng.choice("ACGTN") for _ in range(n))
            .encode() + b"\\n" for i, n in enumerate((3000, 500, 40)))))
    raw = TorchSubsampler(k=31, m=11, s=10.0, device="cpu").sketch_file(path)
    assert raw and raw.split(b" ", 1)[0] == b"51", raw[:40]
    assert OracleSubsampler(k=31, m=11, s=10.0).sketch_file(path) == raw
    for flag, value in (("device_dedup", True), ("native_finisher", False)):
        ss = TorchSubsampler(k=31, m=11, s=10.0, device="cpu")
        setattr(ss, flag, value)
        assert ss.sketch_file(path) == raw and ss._nf_obj is None, flag
    os.chdir(tmp)
    os.environ["TORCH_DEVICE"] = "cpu"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sub_sampler.main(["-i", path, "-s", "10", "-p", "cli_"])
    assert rc == 0 and os.path.getsize("cli_g.gz") > 0, out.getvalue()
    from supersampler_tpu_torch.sketch import sketch_fof
    from supersampler_tpu_torch.utils.profiling import timers
    two = sketch_fof([(TorchSubsampler(k=31, m=11, s=10.0, device="cpu"), p)
                      for p in (path, path)])
    assert two == [raw, raw] and "assemble" in timers.report()
    with open("sk_fof.txt", "w") as f:
        f.write(path + "\\n")
    with contextlib.redirect_stdout(out):
        rc = sub_sampler.main(["-f", "sk_fof.txt", "-s", "10", "-p", "f_"])
    assert rc == 0 and open("f_sk_fof.txt").read() == "f_g.gz\\n"
    assert open("f_g.gz", "rb").read() == open("cli_g.gz", "rb").read()
    gold = os.path.join(REPO, "tests", "golden")
    with open("fof.txt", "w") as f:
        f.writelines(os.path.join(gold, "gfam_fam%d.gz\\n" % i)
                     for i in range(4))
    with contextlib.redirect_stdout(out):
        rc = comparator.main(["-f", "fof.txt"])
    assert rc == 0 and "I found 4 documents" in out.getvalue()
    assert os.path.getsize("results_jaccard.csv.gz") > 0
    with contextlib.redirect_stdout(out):
        rc = norms.main(["results_containment.csv.gz",
                         "results_jaccard.csv.gz"])
    assert rc == 0 and "norm1 = " in out.getvalue()
from supersampler_tpu_torch.parallel import dist, dryrun, mesh
dryrun.dryrun_multichip(2, devices=["cpu"] * 2)
assert dist.process_info() == (0, 1) and mesh.make_mesh(["cpu"]).size == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "supersampler_tpu"))
print("MODULES", len(names), "FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FORBIDDEN []" in r.stdout


@pytest.mark.parametrize("k,m,s", [
    (31, 11, 1000.0), (31, 11, 10.0), (21, 7, 500.0), (63, 15, 2.0),
    (15, 5, 1.5), (31, 11, 1.0), (31, 11, 0.5)])
def test_compute_threshold_matches_jax(k, m, s):
    assert TS.compute_threshold(k, m, s) == JS.compute_threshold(k, m, s)


@pytest.mark.parametrize("x", [0.0, 1.0, 10.0, 1000.0, 1 / 3, 123456789.5,
                               2.5e-7, 31.999999])
def test_number_formats_match_jax(x):
    assert TS.format_g6(x) == JS.format_g6(x)
    assert TS.format_double(x) == JS.format_double(x)


@pytest.mark.parametrize("n", [0, 7, 999, 1000, 1001, 1010, 1100, 999999,
                               1000000, 12345678901])
def test_int_to_string_matches_jax(n):
    assert TS.int_to_string(n) == JS.int_to_string(n)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 8, 61, 1000])
def test_str_compressor_matches_jax(n):
    s = "".join(np.random.default_rng(n).choice(list("ACGT"), n))
    assert TS.str_compressor(s) == JS.str_compressor(s)


def test_host_constants_match_jax():
    for name in ("MASK64", "PRIME1", "PRIME2", "PRIME3", "PRIME4",
                 "PRIME5", "SEED", "INT2NUC"):
        assert getattr(TS, name) == getattr(JS, name), name
    assert TS.NUC2INT_LUT.dtype == JS.NUC2INT_LUT.dtype
    assert np.array_equal(TS.NUC2INT_LUT, JS.NUC2INT_LUT)
    assert [TS.nuc2int(chr(c)) for c in range(256)] == [
        JS.nuc2int(chr(c)) for c in range(256)]
    assert TS._B4_BYTES == JOS._B4_BYTES
    assert TS._COMP_BYTES == JOS._COMP_BYTES
    rng = np.random.default_rng(9)
    for k in (1, 11, 31, 32, 33, 63):
        for _ in range(20):
            num = int(rng.integers(0, 1 << 62)) << 64 | int(
                rng.integers(0, 1 << 62))
            num &= (1 << 2 * k) - 1
            assert TS.num2str(num, k) == JS.num2str(num, k)


@pytest.mark.parametrize("window,max_records", [(1 << 20, 4096), (97, 3)])
def test_stream_fasta_spans_matches_jax(tmp_path, window, max_records):
    rng = np.random.default_rng(2)
    recs = []
    for i in range(40):
        body = bytes(rng.choice(list(b"ACGTNacgt"), int(rng.integers(
            0, 400))))
        lines = [body[j : j + 60] for j in range(0, len(body), 60)]
        recs.append(b">rec%d x\n" % i + b"\n".join(lines) + b"\n")
    path = tmp_path / "r.fa.gz"
    path.write_bytes(gzip.compress(b"".join(recs) + b">tail"))
    got = list(TFA.stream_fasta_spans(str(path), window, max_records))
    want = list(JFA.stream_fasta_spans(str(path), window, max_records))
    assert got == want and len(got) >= 1


def test_fof_and_out_name_match_jax(tmp_path):
    fof = tmp_path / "fof.txt"
    fof.write_text("a.fa\nbb\n/x/y/genome.fa.gz\n\nabcd\n")
    assert TFA.read_fof(str(fof)) == JFA.read_fof(str(fof))
    for p in ("/x/y/genome.fa.gz", "reads", "a.b.c"):
        assert TFA.get_out_name(p, "pre_") == JFA.get_out_name(p, "pre_")


@pytest.mark.parametrize("level", [1, 6, 9])
def test_write_gzip_exact_matches_jax(tmp_path, level):
    data = np.random.default_rng(level).bytes(5000) + b"ACGT" * 500
    TGZ.write_gzip_exact(str(tmp_path / "t.gz"), data, level)
    JGZ.write_gzip_exact(str(tmp_path / "j.gz"), data, level)
    assert (tmp_path / "t.gz").read_bytes() == (tmp_path / "j.gz").read_bytes()
