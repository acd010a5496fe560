"""The port's scalar oracle against the JAX package's, on the CPU.

Tolerance 0 everywhere. The port's OracleSubsampler must equal JAX's
byte for byte, with every print_stat counter equal, on the 10 golden
configurations and on a seeded fuzz of tests/oracle_cases.py's shapes
(three files at each configuration of ``CONFIGS``, and a repeat-rich
record); TorchSubsampler(device="cpu") must equal the port's oracle on
the same fuzz. The port's OracleComparator must write the same CSVs as
JAX's on the family goldens, on sketches of the fuzz (all-vs-all and a
query, at two precisions and a non-zero min_threshold) and on a list
that names a missing file. The port's copies of the decycling set, the
scalar helpers, the FASTA record reader and the gzip writer are held
to their originals."""

import gzip
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import supersampler_tpu.core.decycling as JD
import supersampler_tpu.core.scalar as JS
import supersampler_tpu.io.fasta as JFA
import supersampler_tpu.io.gzip_exact as JGZ
import supersampler_tpu.oracle.comparator as JOC
import supersampler_tpu_torch.core.decycling as TD
import supersampler_tpu_torch.core.scalar as TS
import supersampler_tpu_torch.io.fasta as TFA
import supersampler_tpu_torch.io.gzip_exact as TGZ
import supersampler_tpu_torch.oracle.comparator as TOC
from supersampler_tpu.oracle import OracleComparator as JaxComparator
from supersampler_tpu.oracle import OracleSubsampler as JaxOracle
from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.oracle import OracleComparator, OracleSubsampler
from supersampler_tpu_torch.sketch import TorchSubsampler
from supersampler_tpu_torch.sketch.store import KmerStore, SubsamplerState
from tests import oracle_cases as oc

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
with open(os.path.join(_GOLD, "meta.json")) as _f:
    _META = json.load(_f)

COUNTERS = ("read_kmer", "total_kmer_number", "total_superkmer_number",
            "selected_kmer_number", "selected_superkmer_number",
            "count_maximal_skmer", "nb_mmer_selected",
            "seen_kmers_at_reconstruction",
            "seen_superkmers_at_reconstruction",
            "seen_max_superkmers_at_reconstruction",
            "seen_unique_kmers_at_reconstruction",
            "total_kmer_number_at_reconstruction",
            "actual_minimizer_number")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain CPU path is many small torch ops: one thread a test
    process keeps the workers of a parallel run off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sketch(cls, path, k, m, s, a, **kw):
    """(bytes, counters, log) of one sketch_file."""
    ss = cls(k=k, m=m, s=float(np.float32(s)), abundance=a, **kw)
    ss.log = io.StringIO()
    raw = ss.sketch_file(path)
    return raw, {c: getattr(ss, c) for c in COUNTERS}, ss.log.getvalue()


def _held(path, k, m, s, a, cpu_path=True):
    """The port's oracle == JAX's (bytes, counters, log) and, with
    cpu_path, TorchSubsampler on the CPU == the port's oracle. Returns
    the port oracle's bytes."""
    want = _sketch(OracleSubsampler, path, k, m, s, a)
    assert _sketch(JaxOracle, path, k, m, s, a) == want, "JAX oracle"
    if cpu_path:
        got = _sketch(TorchSubsampler, path, k, m, s, a, device="cpu")
        assert got[0] == want[0], "TorchSubsampler bytes"
        assert got[1] == want[1], "TorchSubsampler counters"
    return want[0]


def test_oracle_builds_on_the_store_and_state():
    """No third copy of the store: the oracle's intake, reconstruction
    and serializer are KmerStore's, its counters SubsamplerState's."""
    assert issubclass(OracleSubsampler, SubsamplerState)
    assert issubclass(OracleSubsampler, KmerStore)
    for name in ("handle_superkmer", "find_first_kmer", "find_next",
                 "reconstruct_superkmer", "serialize", "_reset_stats"):
        assert name not in OracleSubsampler.__dict__, name
    assert TorchSubsampler.serialize is not KmerStore.serialize


@pytest.mark.parametrize("cfg", _META["sketches"],
                         ids=[c["file"] for c in _META["sketches"]])
def test_oracle_equals_jax_on_goldens(datadir, cfg):
    raw = _held(datadir[cfg["dataset"]], cfg["k"], cfg["m"], cfg["s"],
                cfg["a"], cpu_path=False)
    with gzip.open(os.path.join(_GOLD, cfg["file"]), "rb") as f:
        assert raw == f.read()


@pytest.mark.parametrize("ci", range(len(oc.CONFIGS)),
                         ids=["k%d_m%d_s%s_a%d" % c for c in oc.CONFIGS])
def test_oracle_and_cpu_path_on_fuzz(tmp_path, ci):
    """Three fuzz files at one configuration, the last gzip; the first
    carries a 3 kb homopolymer (even ci) or tandem repeat (odd ci)."""
    k, m, s, a = oc.CONFIGS[ci]
    rng = np.random.default_rng(4200 + ci)
    for f in range(3):
        path = str(tmp_path / f"z{f}.fa")
        oc.fuzz_fasta(rng, path,
                      heavy=oc.fuzz_heavy(10 * ci) if f == 0 else None)
        if f == 2:
            with open(path, "rb") as src:
                data = src.read()
            path += ".gz"
            with open(path, "wb") as dst:
                dst.write(gzip.compress(data))
        _held(path, k, m, s, a)


@pytest.mark.parametrize("s", ["64", "1000"])
def test_oracle_and_cpu_path_on_repeat_rich(tmp_path, s):
    rng = np.random.default_rng(77)
    path = tmp_path / "rr.fa"
    path.write_bytes(b">rr\n" + oc.repeat_rich(rng, 20_000) + b"\n>r2\n"
                     + oc.repeat_rich(rng, 3_000) + b"\n")
    _held(str(path), 31, 11, s, 1)


def test_oracle_reports_a_missing_file(tmp_path):
    path = str(tmp_path / "absent.fa")
    want = _sketch(OracleSubsampler, path, 31, 11, "10", 1)
    assert want[0] is None and want[2] == (
        f"Problem with file opening\nCan't open file: {path}\n")
    assert _sketch(JaxOracle, path, 31, 11, "10", 1) == want


def test_regular_minimizer_pos_equals_jax():
    rng = np.random.default_rng(3)
    for k, m in ((31, 11), (21, 7), (63, 15), (15, 5)):
        mine, theirs = OracleSubsampler(k, m, 10.0), JaxOracle(k, m, 10.0)
        for _ in range(300):
            seq = int.from_bytes(rng.bytes(16), "little") & ((1 << 2 * k) - 1)
            assert mine.regular_minimizer_pos(seq) == (
                theirs.regular_minimizer_pos(seq))
        for unit in (0, 1, 2, 3, 0b0110, 0b1001):   # homopolymers, tandems
            seq = 0
            for _ in range(k):
                seq = (seq << 2 | unit & 3) & ((1 << 2 * k) - 1)
                unit = unit >> 2 | (unit & 3) << 2
            assert mine.regular_minimizer_pos(seq) == (
                theirs.regular_minimizer_pos(seq))


# ---- the comparator ----

def _compare(cls, names, query_size, precision=6, min_threshold=0.0):
    comp = cls(precision=precision, min_threshold=min_threshold)
    comp.files_names = list(names)
    out = io.StringIO()
    with redirect_stdout(out):
        comp.compare_sketches(query_size)
    return (comp.containment_csv(), comp.jaccard_csv(), out.getvalue(),
            comp.score_A, comp.nb_kmer_seen_infile)


@pytest.fixture
def golden_family(tmp_path, monkeypatch):
    cfg = _META["compare"]
    for f in cfg["files"]:
        os.symlink(os.path.join(_GOLD, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    return cfg


def _golden_csv(name):
    with gzip.open(os.path.join(_GOLD, name), "rb") as f:
        return f.read().decode()


def test_comparator_equals_jax_on_golden_families(golden_family):
    cfg = golden_family
    got = _compare(OracleComparator, cfg["files"], len(cfg["files"]))
    assert got == _compare(JaxComparator, cfg["files"], len(cfg["files"]))
    assert got[:2] == (_golden_csv("allvsall_containment.csv.gz"),
                       _golden_csv("allvsall_jaccard.csv.gz"))
    names = cfg["query_files"] + cfg["bank_files"]
    args = (names, len(cfg["query_files"]), cfg["query_precision"],
            cfg["query_min_threshold"])
    got = _compare(OracleComparator, *args)
    assert got == _compare(JaxComparator, *args)
    assert got[:2] == (_golden_csv("query_containment.csv.gz"),
                       _golden_csv("query_jaccard.csv.gz"))


def test_comparator_drops_a_missing_file(golden_family):
    names = ["gfam_fam0.gz", "missing.gz", "gfam_fam2.gz", "gfam_fam3.gz"]
    got = _compare(OracleComparator, names, len(names))
    assert got == _compare(JaxComparator, names, len(names))
    assert got[2] == "Problem with file opening\n"
    assert len(got[4]) == 3


@pytest.fixture(scope="module")
def fuzz_sketches(tmp_path_factory):
    """Sketches of fuzz files at (31, 11) and s = 2, 10 and 64 (one per
    file), written as the CLI writes them, and one of a file of the
    same shapes shared by two of them, so that the files overlap."""
    from supersampler_tpu_torch.io.gzip_exact import write_gzip_exact

    d = tmp_path_factory.mktemp("cmp")
    rng = np.random.default_rng(99)
    shared = str(d / "shared.fa")
    oc.fuzz_fasta(rng, shared, n_records=6)
    with open(shared, "rb") as f:
        shared_text = f.read()
    paths = []
    for i, s in enumerate(("2", "10", "64", "10", "2", "64")):
        fa = str(d / f"f{i}.fa")
        oc.fuzz_fasta(rng, fa, heavy=("tandem" if i == 3 else None))
        if i in (1, 3, 4):
            with open(fa, "ab") as f:
                f.write(b"\n" + shared_text)
        raw = OracleSubsampler(31, 11, float(s)).sketch_file(fa)
        paths.append(str(d / f"f{i}.gz"))
        write_gzip_exact(paths[-1], raw, level=9)
    return paths


@pytest.mark.parametrize("precision,min_threshold", [(6, 0.0), (3, 0.05)])
@pytest.mark.parametrize("query_size", [None, 2])
def test_comparator_equals_jax_on_fuzz_sketches(fuzz_sketches, precision,
                                                min_threshold, query_size):
    q = len(fuzz_sketches) if query_size is None else query_size
    args = (fuzz_sketches, q, precision, min_threshold)
    got = _compare(OracleComparator, *args)
    assert got == _compare(JaxComparator, *args)
    assert got[3], "the fuzz sketches share no k-mer"
    numpy_engine = TorchComparator(precision, min_threshold, engine="numpy")
    numpy_engine.files_names = list(fuzz_sketches)
    numpy_engine.compare_sketches(q)
    assert (numpy_engine.containment_csv(),
            numpy_engine.jaccard_csv()) == got[:2]


def test_inject_minimizer_and_cursor_equal_jax(fuzz_sketches):
    rng = np.random.default_rng(5)
    for _ in range(50):
        half = int(rng.integers(1, 30))
        s = "".join(rng.choice(list("ACGT"), 2 * half * int(
            rng.integers(0, 4))))
        assert TOC.inject_minimizer(s, "ACGTA", 2 * half) == (
            JOC.inject_minimizer(s, "ACGTA", 2 * half))
    for path in fuzz_sketches:
        mine, theirs = TOC.SketchCursor(path), JOC.SketchCursor(path)
        assert mine.read_header() == theirs.read_header()
        assert mine.data == theirs.data


# ---- the host helpers ----

@pytest.mark.parametrize("m", [3, 5, 7, 9, 11])
def test_decycling_equals_jax(m):
    seqs = np.arange(4 ** m, dtype=np.uint64)
    assert np.array_equal(TD.mem_double_vec(seqs, m),
                          JD.mem_double_vec(seqs, m))
    assert np.array_equal(TD.compute_r_vec(seqs[:4096], m),
                          JD.compute_r_vec(seqs[:4096], m))
    mine, theirs = TD.DecyclingSet(m), JD.DecyclingSet(m)
    assert mine.coef == theirs.coef
    for x in np.random.default_rng(m).integers(0, 4 ** m, 500):
        x = int(x)
        assert mine.compute_r(x) == theirs.compute_r(x)
        assert mine.mem(x) == theirs.mem(x)
        assert mine.mem_double(x) == theirs.mem_double(x)


def _u64s(rng, n):
    edge = [0, 1, 2, TS.MASK64, TS.MASK64 - 1, 1 << 63, (1 << 63) - 1]
    return edge + [int.from_bytes(rng.bytes(8), "little") for _ in range(n)]


def test_hash_helpers_equal_jax():
    rng = np.random.default_rng(11)
    for x in _u64s(rng, 2000):
        assert TS.unrevhash(x) == JS.unrevhash(x)
        assert TS.xxhash64_u64(x, 7) == JS.xxhash64_u64(x, 7)
        for r in (1, 27, 31, 33, 63):
            assert TS.rotl64(x, r) == JS.rotl64(x, r)


def test_code_helpers_equal_jax():
    rng = np.random.default_rng(12)
    for c in map(chr, range(256)):
        assert TS.nuc2intrc(c) == JS.nuc2intrc(c)
    assert [TS.int2nuc(i) for i in range(4)] == [
        JS.int2nuc(i) for i in range(4)]
    for n in (1, 5, 11, 15, 21, 31, 32, 63):
        for x in _u64s(rng, 100):
            x &= (1 << 2 * n) - 1
            assert TS.revcomp_code(x, n) == JS.revcomp_code(x, n)
            assert TS.canonize(x, n) == JS.canonize(x, n)
    for n in (0, 1, 7, 31, 64, 200):
        s = "".join(rng.choice(list("ACGTNacgt"), n))
        assert TS.revcomp_str(s) == JS.revcomp_str(s)
        assert TS.str2num(s) == JS.str2num(s)
        clean = s.upper().replace("N", "")
        assert TS.str2num_fast(clean) == JS.str2num_fast(clean) == (
            TS.str2num(clean))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 61, 1000])
def test_str_decompressor_inverts_str_compressor(n):
    rng = np.random.default_rng(n)
    s = "".join(rng.choice(list("ACGT"), n))
    assert TS.str_decompressor(TS.str_compressor(s)) == s
    blob = bytes([n % 4]) + rng.bytes(n // 3 + 1) if n else b""
    assert TS.str_decompressor(blob) == JS.str_decompressor(blob)


def test_parse_rate_arg_equals_jax():
    for s in ("1", "1000", "10", "0.5", "1.1", "64", "3.3333333", "1e3",
              "123456789.123"):
        assert TS.parse_rate_arg(s) == JS.parse_rate_arg(s)


def test_fasta_records_and_gzip_equal_jax(tmp_path):
    rng = np.random.default_rng(21)
    for i in range(12):
        path = str(tmp_path / f"r{i}.fa")
        oc.fuzz_fasta(rng, path, n_records=int(rng.integers(0, 6)))
        assert list(TFA.iter_fasta_raw(path)) == list(
            JFA.iter_fasta_raw(path))
        assert list(TFA.iter_fasta_records(path)) == list(
            JFA.iter_fasta_records(path))
    raw = bytes(range(256)) * 3 + b">x\nacgtNNRY\r\n"
    assert TFA.clean_dna(raw) == JFA.clean_dna(raw)
    for level in (1, 6, 9):
        data = rng.bytes(3000) + b"ACGT" * 400
        assert TGZ.gzip_compress_exact(data, level) == (
            JGZ.gzip_compress_exact(data, level))
